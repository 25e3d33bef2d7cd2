"""Free-running generation with per-step self-perplexity: the port's
counterpart of ``dynamic_llava_tpu/eval/self_ppl.py`` (the reference's
``run_llava_for_ppl.py`` / ``model_vqa_science_for_ppl.py``): at each
decode step the "self" log-probability is the max of the step's
log-softmax, the greedy token's probability however the next token is
chosen, and the reported perplexity is the mean of exp(-logp) over steps.

The per-token tools (this one, ``model_lvis_for_ppl``,
``model_lvis_multi_round``) read every step's logits on the host, so they
run ``dynamic.decode_step`` eagerly a token at a time (the JAX tools call
the jitted step the same way), on a state prefilled into a cache of its
own (``prefill_state``), apart from the ``Generator``'s decode runner.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def prefill_state(gen, plan, pixel_values, max_new_tokens: int):
    """``(state, info)``: ``dynamic.prefill`` of ``plan`` into a new cache
    with room for ``max_new_tokens`` (the capacities of
    ``gen.cache_sizes``), as the JAX ``Generator.prefill_from_plan`` makes
    one a call. The ``Generator``'s runner, its cache and its graph, stay
    as they were."""
    from ..generation.generate import CACHE_DTYPES
    from ..ops.kv_cache import init_tiered_cache

    cfg = gen.cfg
    cache = init_tiered_cache(cfg.text, cfg.sparse.sparse_layer, plan.batch,
                              *gen.cache_sizes(plan, pixel_values, max_new_tokens),
                              CACHE_DTYPES[gen.gen_cfg.cache_dtype], gen.device)
    return gen.prefill_into(plan, pixel_values, cache)


def decode_token(gen, state, token: int):
    """One eager ``dynamic.decode_step`` of ``token`` (a batch of one)."""
    from ..models import dynamic

    return dynamic.decode_step(gen.params, gen.cfg,
                               torch.full((1,), int(token), device=gen.device), state)


def host_logits(state) -> np.ndarray:
    """Sample 0's last logits ``[V]`` on the host, fp32."""
    return state.last_logits[0].float().cpu().numpy()


def log_softmax(logits: np.ndarray) -> np.ndarray:
    """The JAX tools' host log-softmax, in their order of operations."""
    logp = logits - logits.max()
    return logp - np.log(np.sum(np.exp(logp)))


def tier_lengths(state):
    """``(pre, post)``: the pre tier's length at its first layer and the
    post tier's at its last, of sample 0 (the JAX tools' ``[0, 0]`` and
    ``[-1, 0]`` reads of the ``[L, B]`` lengths)."""
    return (int(state.cache.pre.length[0, 0].item()),
            int(state.cache.post.length[-1, 0].item()))


@torch.inference_mode()
def generate_with_self_ppl(
    runtime,
    tokenizer,
    input_ids: np.ndarray,
    pixel_values,
    max_new_tokens: int = 512,
    temperature: float = 0.0,
    seed: int = 0,
) -> Dict:
    """Greedy or sampled generation that also records per-step self-PPL:
    ``tokens``, ``text``, ``self_ppl``, ``answer_token_len``. Greedy is the
    JAX tool's token for token; a sampled token is drawn from a
    ``torch.Generator`` seeded with ``seed`` on the params' device."""
    from ..generation.generate import GenerationConfig, Generator, _sample
    from ..multimodal.fusion import plan_batch

    gen = Generator(runtime.params, runtime.cfg,
                    GenerationConfig(max_new_tokens=max_new_tokens,
                                     temperature=temperature,
                                     eos_token_id=tokenizer.eos_token_id))
    plan = plan_batch([input_ids], runtime.cfg.num_image_tokens
                      if pixel_values is not None else 0)
    state, _ = prefill_state(gen, plan, pixel_values, max_new_tokens)

    rng = torch.Generator(device=gen.device).manual_seed(seed)
    tokens: List[int] = []
    step_ppls: List[float] = []
    for _ in range(max_new_tokens):
        logits = host_logits(state)
        step_ppls.append(float(np.exp(-log_softmax(logits).max())))
        if temperature > 0:
            tok = int(_sample(rng, state.last_logits[:1], temperature, 1.0)[0])
        else:
            tok = int(np.argmax(logits))
        if tok == tokenizer.eos_token_id:
            break
        tokens.append(tok)
        state = decode_token(gen, state, tok)

    return {
        "tokens": tokens,
        "text": tokenizer.decode(tokens, skip_special_tokens=True).strip(),
        "self_ppl": float(np.mean(step_ppls)) if step_ppls else 0.0,
        "answer_token_len": len(tokens),
    }


def prepare_image_prompt(qs: str, runtime_cfg, image_path: Optional[str],
                         image_processor, conv_mode: str, tokenizer):
    """Wrap a question with the image token + conversation template and
    tokenize; returns (input_ids, pixel_values)."""
    from PIL import Image

    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..conversation import conv_templates
    from ..mm_utils import process_images, tokenizer_image_token

    pixels = None
    if image_path is not None:
        image = Image.open(image_path).convert("RGB")
        pixels = process_images([image], image_processor, runtime_cfg)
        qs = DEFAULT_IMAGE_TOKEN + "\n" + qs
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    ids = np.asarray(tokenizer_image_token(conv.get_prompt(), tokenizer),
                     np.int64)
    return ids, pixels
