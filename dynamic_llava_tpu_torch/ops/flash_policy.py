"""Fused policy attention (training-mode masked softmax): kernel K4 and its
plain PyTorch version.

Counterpart of ``dynamic_llava_tpu/ops/flash_policy.py``
(``flash_policy_attention`` over the Pallas ``_policy_kernel``, and
``flash_policy_attention_vjp``). Both versions compute, causally,

    w_ij  = (exp(s_ij - m_i) * p'_ij + eps/N) / (sum_j exp(s_ij - m_i) * p'_ij + eps)
    out_i = sum_j w_ij v_j

where ``p'`` is the kv policy with its diagonal forced to 1, ``m_i`` the
row maximum of the causally masked scores, ``N`` the sequence length, and
the ``eps/N`` term covers every column, masked ones too; all in fp32, the
output in q's dtype. On a CUDA tensor ``flash_policy_attention`` launches
the hand-written Hopper kernel ``csrc/flash_policy_fwd.cu``; on a CPU
tensor it runs ``flash_policy_attention_plain``. There is no fallback from
one to the other.

``flash_policy_attention_vjp`` is the differentiable entry. Its backward
recomputes the attention blockwise with plain tensor ops
(``ops.attention.blockwise_attend``) and differentiates that, as the JAX
package does: it has no backward kernel for the policy path either.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .attention import attend_with_policy, blockwise_attend
from .flash_attention import _check, check_qkv


def flash_policy_attention_plain(
    q: torch.Tensor,  # [B, S, H, d]
    k: torch.Tensor,  # [B, S, Hkv, d]
    v: torch.Tensor,  # [B, S, Hkv, d]
    policy: torch.Tensor,  # [B, S]
    *,
    scale: Optional[float] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    s = q.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()[None, None]
    return attend_with_policy(q, k, v, policy, mask=causal, scale=scale, eps=eps)


def flash_policy_attention(
    q: torch.Tensor,  # [B, S, H, d]
    k: torch.Tensor,  # [B, S, Hkv, d]
    v: torch.Tensor,  # [B, S, Hkv, d]
    policy: torch.Tensor,  # [B, S] soft keep mask over the kv tokens
    *,
    scale: Optional[float] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Fused causal policy attention (see the module docstring)."""
    if q.device.type == "cpu":
        return flash_policy_attention_plain(q, k, v, policy, scale=scale, eps=eps)
    if not q.is_cuda:
        raise ValueError(f"flash_policy_attention: unsupported device {q.device}")
    check_qkv("flash_policy_attention", q, k, v)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[1] != s:
        raise ValueError(
            f"flash_policy_attention: self-attention only, got q {tuple(q.shape)} "
            f"k {tuple(k.shape)}")
    policy = policy.float().contiguous()
    _check("policy", policy, torch.float32, 2, align=4)
    if policy.shape != (b, s) or policy.device != q.device:
        raise ValueError("flash_policy_attention: policy must be [B, S] on q's device")
    out = torch.empty_like(q)
    vsum = torch.empty((b, hkv, d), dtype=torch.float32, device=q.device)
    code = kernels.load_library().lib.flash_policy_attention_fwd(
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(policy),
        kernels.ptr(vsum), kernels.ptr(out), b, s, h, hkv, d,
        float(d**-0.5 if scale is None else scale), float(eps),
        kernels.DTYPE_CODES[q.dtype], kernels.stream_of(q),
    )
    kernels.check(code, "flash_policy_attention_fwd")
    flash_policy_attention.launches += 1
    return out


flash_policy_attention.launches = 0


class _FlashPolicyFn(torch.autograd.Function):
    """K4 forward; the backward differentiates a blockwise recompute of the
    same attention (O(block x S) memory)."""

    @staticmethod
    def forward(ctx, q, k, v, policy):
        ctx.save_for_backward(q, k, v, policy)
        return flash_policy_attention(q, k, v, policy)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            q, k, v, policy = inputs
            out = blockwise_attend(q, k, v, policy=policy)
        wanted = [t for t, n in zip(inputs, need) if n]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if n else None for n in need)


def flash_policy_attention_vjp(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    policy: torch.Tensor,
) -> torch.Tensor:
    """Differentiable fused policy attention. Without anything to
    differentiate it is ``flash_policy_attention`` itself."""
    if not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, policy))):
        return flash_policy_attention(q, k, v, policy)
    return _FlashPolicyFn.apply(q.contiguous(), k.contiguous(), v.contiguous(), policy)
