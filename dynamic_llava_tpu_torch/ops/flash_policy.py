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
one to the other. A head_dim below 64 (or between 64 and 128) is zero-padded
as in ``ops.flash_attention``.

``flash_policy_attention_vjp`` is the differentiable entry, through the
dispatcher op ``flash_policy_forward``. Its backward
recomputes the attention blockwise with plain tensor ops
(``ops.attention.blockwise_attend``) and differentiates that, as the JAX
package does: it has no backward kernel for the policy path either.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..kernels import counts
from .attention import attend_with_policy, blockwise_attend
from .flash_attention import OP_RUNS, _check, check_qkv, kernel_head_dim, pad_head_dim


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
    d = q.shape[-1]
    kd = kernel_head_dim(d)
    if kd != d:  # a smaller head_dim, zero-padded (see ``ops.flash_attention``)
        out = flash_policy_attention(*(pad_head_dim(t, kd) for t in (q, k, v)), policy,
                                     scale=d**-0.5 if scale is None else scale, eps=eps)
        return out[..., :d].contiguous()
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
    counts.launched("flash_policy_attention_fwd")
    flash_policy_attention.launches += 1
    return out


flash_policy_attention.launches = 0


# F2 for K4: the forward as a dispatcher op (see ``flash_attention.flash_forward``),
# so that the ``flash`` remat policies keep its output from the first
# forward (the JAX ``flash_policy_out`` name); the backward recomputes the
# attention blockwise from q / k / v / policy either way.
@torch.library.custom_op("dynamic_llava::flash_policy_forward", mutates_args=())
def flash_policy_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         policy: torch.Tensor) -> torch.Tensor:
    """``flash_policy_attention``: K4 on a CUDA tensor, the plain version on
    a CPU tensor."""
    OP_RUNS["flash_policy_forward"] += 1
    return flash_policy_attention(q, k, v, policy)


@flash_policy_forward.register_fake
def _(q, k, v, policy):
    return torch.empty_like(q)


def _policy_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _policy_backward(ctx, g):
    """Differentiates a blockwise recompute of the same attention
    (O(block x S) memory)."""
    need = ctx.needs_input_grad
    inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
    with torch.enable_grad():
        out = blockwise_attend(*inputs[:3], policy=inputs[3])
    wanted = [t for t, n in zip(inputs, need) if n]
    grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(grads) if n else None for n in need)


flash_policy_forward.register_autograd(_policy_backward, setup_context=_policy_setup)


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
    return flash_policy_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                                policy.contiguous())
