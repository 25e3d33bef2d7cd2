#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card with 80 GB, ``nvcc``,
PIL, ``tokenizers`` and ``transformers``, ~45 GB free in the temporary
directory (phase 9d's final save; phase 5e's checkpoint takes 15 GB) and
about twenty minutes, and fails (exit code != 0, no result line) anywhere
else. Phases, each of which raises on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``dynamic_llava_tpu_torch/csrc``
   with ``nvcc`` for ``sm_90a`` (one process per source, in parallel) and
   print the build time and ``ptxas`` resource lines;
3. hold each kernel against its plain PyTorch version at the shapes of the
   main paths, timing both with CUDA events on a CUDA-graph replay, and
   beside them the one PyTorch call that computes the same function where
   there is one (a yardstick timed here and used nowhere in the port).
   K1/K2: bf16 inputs against the plain version in fp32 on the same
   values, atol = rtol = 2e-2 (bf16 output rounding, and in K1 and K3 the
   probabilities and dS rounded to bf16 for the tensor cores); fp32 inputs
   at atol = rtol = 1e-4. K3 (dq, dk, dv each, and its delta kernel) and K4
   at the training shape (B=4, S=1663, H=32, d=128) the same way; K4's bf16
   error there must also be at most twice that of the output's own bf16
   rounding, and it is timed beside SDPA with a causal + log(policy) float
   mask (not the same function: no eps terms) and with its column-sum
   kernel apart; K4 also at every ``kernel_cases.POLICY_EDGE_CASES`` case
   (S = 1, 63, 64, 65, 129; 4 query heads a KV head; d 64 and 128; a policy
   of zeros, ones or soft values; bf16 and fp32), each launched twice with
   ``torch.equal`` results. K1 and
   K3 at every ``kernel_cases.FLASH_FWD_CASES`` / ``FLASH_BWD_CASES`` case,
   the edges of their 64-row tiles among them (S = 64, 65, 130, 200; GQA
   with 4 query heads a KV head; a ``kv_length`` of 0 and one in mid-tile;
   K1 with a ``q_offset`` and Sq < Sk; bf16 and fp32; head_dim 16 and 32,
   zero-padded to 64 by the wrappers), each launched twice with
   ``torch.equal`` results; K1 is timed (at the decoder's pre tier, the
   CLIP tower and ``kernel_cases.TIMED_FLASH_SHAPES``: an anyres prefill
   at S=2944, Mistral's GQA 32 / 8 at S=4096, the tower over S2's 14
   tiles) beside SDPA both with the masks
   as a bool tensor and, at full lengths, with ``is_causal``; K3's delta
   kernel beside ``torch.linalg.vecdot`` on the fp32 values it forms;
   ``torch.autograd.grad`` through K1 + K3 against autograd through the
   plain forward, and the gradient of an unfrozen CLIP tower on the card
   against the CPU's. K2 at every ``kernel_cases.DECODE_CASES`` case: bf16,
   fp32, scaled-int8 and fp8 storage; lengths 0, 1, below / at / above the
   kernel's tile and split edges, at the capacity and past it; a sliding
   window, also one that opens inside a split; head_dim 64 and 128 (and 16
   and 32, zero-padded); 1-8 query heads a KV head; B = 8; each launched
   twice with ``torch.equal``
   results; timed at max_len 768 / 256 and B = 4 / 8 beside one SDPA call
   (for int8 / fp8 storage: on the dequantized bf16 cache), and past
   Mistral's window (B=1, GQA 32 / 8, length 4700, window 4096) beside
   SDPA over the window's rows. K2's M-query
   form (K2-M, the continuation prefill's chunk attention; a bf16 q over a
   bf16, int8 or fp8 cache on the tensor cores, ``extend_mma_kernel``, an
   fp32 q or cache on the CUDA cores, ``extend_kernel``) at every
   ``kernel_cases.EXTEND_CASES`` case: all four storage types; M x n_rep
   across the 16- and 64-row tiles of the one and the groups of 8 query
   rows of the other; 1, 4 and 8 query heads a KV head; head_dim 64 and
   128; B = 1-4 with ragged lengths at 0, the tile and split edges and the
   capacity; a chunk_attend mask (all false too) and a window (also across
   a tile's rows); each launched twice with ``torch.equal`` results, at the
   same tolerances as K2, each once more in one profiler trace that must
   show the kernel ``extend_plan`` names, and at the speculative verify
   shapes
   (``kernel_cases.VERIFY_CASES``: B = 1 and 8, M = 5 and 8, 32 heads,
   d=128, post-tier lengths 150-300, bf16 and int8, with chunk_attend);
   timed at the chat phase's shapes (B=1, M=40 at length 700 and M=100 at
   804, bf16 and int8) and at the verify shapes beside one SDPA call on the
   cache and the chunk concatenated, with the mask as a bool tensor.
   K5-K8 (int8 /
   int4 GEMVs) at the 7B decoder's shapes (q/k/v, gate/up, down with
   K = 11008, o, the lm_head with N = 32000) and rows 1, 8, 24, 64, and at
   the ``kernel_cases.QUANT_EDGE_CASES`` (a three-weight group of unequal
   widths, widths and K that end inside a tile or a k16 step, the 13B
   shapes, widths that are not a multiple of 64, fp32 x), each launched
   twice with ``torch.equal`` results: max abs error relative to max |ref|
   within 1e-2 for bf16 outputs, 1e-4 for fp32 ones (the lm_head, fp32 x); the weights rotate through copies larger than the 50 MB L2, as
   a decode step finds them cold, and the yardstick (``@`` on the
   dequantized bf16 weight) is timed on one copy and, at rows 8, rotated
   the same way. K9 (the fused int4 MLP) at the 7B and 13B MLP shapes and
   the same rows and at ``kernel_cases.MLP_EDGE_CASES`` (F and D that end
   inside a tile, K inside a unit, unsliced phases) at rows 1, 7, 17, 64,
   bf16 x and fp32 x with fp32 out (1e-2 / 1e-3 of max |ref|), each
   launched twice with ``torch.equal`` results, beside the two-kernel path
   it fuses and three bf16 matmuls on the dequantized weights. A
   tensor-core attention kernel, the decode-attention kernel or its
   M-query form, the bf16 GEMV kernel or the fused MLP that spills
   registers fails the run (phase 2);
4. a small model (head_dim 64, GQA) on the card through the kernels
   against the port's plain CPU path, which the CPU tests hold against the
   JAX package: greedy generation in fp32 with plain, int8 and int4
   weights, token for token; the lean modes (int8 and fp8 KV, ring
   overflow, int4 with the fused MLP) by their logits under teacher
   forcing; and two train steps in fp32 on shared Gumbel
   noise, losses within rtol 1e-3 and every parameter within atol 1e-4;
4b. the quality gates on the card (``quality_gates``): the vision gate, the
   output-text gate and the train-then-evaluate chain of
   ``dynamic_llava_tpu_torch/run/``, fp32, seed 0, at the JAX tests' configs
   and step counts (head_dim 16, zero-padded to 64 by the attention
   wrappers), trained and evaluated through K1, K3, K4 and K2 (and K5 / K6
   for the chain's int8 answers), each kernel's counter zeroed before a
   gate and required to rise in it; the first training steps and the
   evaluation of each gate held against the CPU's on the same weights and
   noise; the JAX tests' thresholds computed for each gate and printed with
   its rows on the ``quality`` line (which of them must hold: see
   ``quality_gates``);
5. serving at LLaVA-1.5-7B width (32 layers, random bf16 weights made on
   the card from a seed): two batches of 8 requests (one 336x336 image
   and 60 text tokens each, 64 new tokens, greedy) through
   ``Generator.generate``, sparse and then dense: the main path. Decode
   replays a CUDA graph of the step (captured in the first call), whose
   replays launch their kernels without a wrapper call; so in each
   serving mode of phases 5-8 the wrappers' counters (host calls: eager
   launches and the capture's) are zeroed just before the two calls and
   read just after, and the serving kernels' launches on the card are
   counted by name in a ``torch.profiler`` trace of the same two calls
   (``kernel_cases.device_launches``). Those must equal twice the wrapper
   calls of an eager loop of ``argmax`` + ``decode_step`` written here
   (``eager_decode``) over the same prefill and steps, and the graph's
   tokens the eager loop's;
5b. multi-round chat at 7B width through ``ChatSession.ask`` on the first
   CHAT_DEPTH of the phase-5 decoder's 32 layers (views of its stacked
   weights; cut for the script's time limit), sparse, dense, and sparse
   with an int8 KV cache: round
   1 one 336x336 image and 60 text tokens, rounds 2 and 3 chunks of 40 and
   100 tokens through the continuation prefill (K2-M), each round to 64
   new tokens under a two-token keyword stop. On the card, in profiler
   traces of one session's three rounds (one a round), K2-M launches once a
   layer in each
   continued round and K2 once a layer in every decode step the session's
   stopping runner (one captured CUDA graph, replayed) ran; a second
   session driven by the eager per-token path must give the same tokens,
   tier lengths and ``next_pos`` after every round; a third is timed:
   round-1 TTFT, the continuation's ms a chunk, decode tok/s at B=1;
5c. speculative decoding and beam search at 7B width on the first
   SPEC_DEPTH of the phase-5 decoder's 32 layers (views of its stacked
   weights; cut for the script's time limit): B=1 and B=8 (an image and 60
   text tokens a request, 128 new tokens, EOS off), sparse and dense, and after phase 6's int8 serving a
   B=8 sparse arm on the int8 decoder; each arm at k = 4 and 7 draft tokens
   (``speculate``): plain ``generate``, ``generate_speculative`` with an
   oracle draft (plain greedy's continuation), a self oracle (the device
   run's chain) and prompt lookup, and ``generate_speculative_device`` (the in-graph lookup, chunks
   of rounds); tok/s, rounds, tokens a round, no-op rounds, the verify
   round's and the plain step's device ms, the tok/s of every draft
   accepted (computed from the round's ms), capture ms. The graph runner's
   tokens, tier lengths and ``next_pos`` must equal an eager loop of
   ``decode_speculative_step`` with the same drafts over its first
   ``SPEC_EAGER_ROUNDS`` rounds, and the host-drafted runner's after a
   whole generation; in a profiler trace of
   a host-drafted generation K2-M must launch once a layer a round and K2
   never, and on the int8 decoder the GEMV kernel ``4 x layers + 1`` times
   a round; the tokens must equal plain greedy's, or leave them only where
   plain greedy's top-two logit gap or a token's keep margin is below a
   bound derived from bf16 rounding (``near_tie_bound``), printed with the
   matched prefix. Then ``beam_search`` (4 beams, 16 tokens): its wall time
   and its length-normalised log-probability against greedy's;
5d. continuous batching at 7B width (``continuous``) on the first
   CONT_DEPTH of the phase-5 decoder's 32 layers (views; cut for the
   script's time limit):
   16 requests of one 336x336 image and 60 text tokens (bucket 640), 64 and
   128 new tokens in turn, EOS off, arriving every 300 ms; 8 slots, chunks
   of 16. Arms, each prewarmed first on the object then timed: the
   ``ContinuousEngine`` (two of the requests sampled, temperature 0.8,
   top-p 0.9, so that its sampling graph runs), the window batcher
   (``run/continuous_bench.py``'s: what has arrived, padded to 8 rows, one
   ``Generator`` a ``max_new`` value), the engine with ``spec_k=4``, and,
   after phase 6's int8 serving, the engine and the window batcher on the
   int8 decoder with an fp8 KV cache. Each arm's main path is one pass with
   every request submitted at once, its wrapper counts zeroed just before
   and read just after and its launches counted in a profiler trace: an
   engine's chunks replay graphs (no eager step after a form's capture, no
   decode / verify wrapper call), K2 (plain) or K2-M (speculative) launches
   once a layer a step, the int8 GEMV ``4 x layers + 1`` times a step plus
   once an admission, admissions launch K1, and its admission cache is one
   cache of 8 rows; then a pass timed on the host clock with arrivals at
   their times: makespan, tok/s, completion latency and TTFT (mean, p95),
   admission ms by batch size, capture ms, prewarm s, peak, cache and
   admission-pool GiB. Greedy tokens of the engines must equal the window
   batcher's on the same weights and cache (the speculative engine's also
   the plain engine's), or leave them only at a near tie
   (``near_tie_bound``, as in phase 5c);
5e. the checkpoint path at 7B width on the first CKPT_DEPTH (16) of the
   phase-5 decoder's 32 layers (views; cut for the script's time limit, as
   are 5f and 5g, which serve this checkpoint) (``checkpoint``):
   ``export_hf_checkpoint`` to a temporary directory (removed at the end of
   the phase), ``load_pretrained_model`` back onto the card (every leaf
   ``torch.equal`` to the phase-5 weights, the config equal), greedy
   ``Generator.generate`` of phase 5's sparse batch (the tokens the same
   views give before the export),
   two rounds of the chat CLI's loop (``serve.cli.chat_loop``, a word-level
   stand-in tokenizer) against the same loop on the phase-5 weights, and
   the VQA CLI (``eval.model_vqa_loader.eval_model``) on three questions,
   plain and with ``--spec_k 4``, on the checkpoint loaded again in fp32
   (equal answers), then the offline eval generators on that load through
   ``eval_model(args, loaded=...)`` (``eval_generators``: ``model_vqa``,
   whose answers must equal the VQA CLI's, ``model_vqa_science``,
   ``model_vqa_qbench``, ``model_qa`` text-only, and ``model_vqa_mmbench``
   where ``pandas`` imports; three questions, 32 tokens each) and their
   scorers; K1, K2 and K2-M counted (wrappers zeroed at the start,
   profiler traces of the calls), the export and load seconds, the host's
   peak RSS and the device's peak printed (the ``checkpoint`` line);
5f. serving over HTTP at 7B width on phase 5e's checkpoint, before its
   directory is removed (``serving``): a controller and one worker at a
   time on the stdlib server (loopback, port 0), each loading the
   checkpoint itself with a word-level stand-in tokenizer, registered, then
   closed, shut down and dropped: the ``ModelWorker`` (4 greedy image
   requests of 64 tokens through the controller one at a time, then at
   once, each equal to ``Generator.generate`` at B=1 on its weights; one
   sampled), the ``ModelWorker`` with ``--spec-k 4`` (2 greedy requests,
   equal or apart at a near tie), the ``BatchedWorker`` window (8 requests
   at once, each equal to ``Generator.generate`` of the batch the worker
   formed; the count equal to the solo answers reported) and
   ``--continuous`` (4 slots; 8 at once, each equal to the window's answer
   or apart at a near tie). The K1 / K2 / K2-M wrappers are zeroed before
   each send and read after it (no trace); each must launch. The
   ``serving`` line: per arm each request's time to first streamed text,
   completion ms and tok/s (client clock), the concurrent sends' makespan,
   each worker's load s and captures, the device's peak and the
   ``requests`` version;
5g. the generation-quality probes and the bench core at 7B width,
   CKPT_DEPTH of 32 layers, after 5f on phase 5e's checkpoint
   (``ppl_tools``): the tools on
   the checkpoint loaded again in fp32 with the word-level tokenizer,
   through ``eval_model(args, loaded=...)``: ``run_llava_for_ppl`` (one
   image prompt, 32 tokens; its greedy tokens must equal
   ``Generator.generate`` at B=1 on the same load), ``model_vqa_science_for_ppl``
   (two problems), ``model_lvis_for_ppl`` sparse and dense (two records
   with 33-token answers; sparse, the post tier after the prefill must be
   shorter than the pre tier and the decode tokens it persisted at most
   the answer's; the dense PPL must equal exp of the mean NLL of one dense
   ``forward_nocache_eval`` pass over the prompt and the answer's prefixes
   within PPL_RTOL relative), ``model_lvis_for_meteor`` (two records),
   ``model_lvis_multi_round`` in ppl mode (three rounds: K2-M once a layer
   a continued round) and ``visualize`` (the keep budget kept); then on
   the phase-5 bf16 weights ``bench_config`` sparse and dense (B=8, 640
   tokens, 64 new tokens, 3 prefill repetitions; its greedy tokens and
   cache capacities must equal ``Generator.generate``'s and
   ``Generator.cache_sizes``' for the same batch) and
   ``long_text_memory`` at one length (64 tokens). The K1 / K2 / K2-M
   wrappers are zeroed at its start and read at its end (no trace); each
   must launch. The ``ppl_tools`` line (per tool its PPL, cache lengths,
   seconds, wrapper calls, memory fields) and the ``bench_core`` line
   (TTFT, device TTFT, decode tok/s, capacities, peak GiB, sparse and
   dense; the long-text records);
5h. high resolution and the other towers at 7B width, 32 layers, on the
   phase-5 weights (``hires``), ``model_max_length`` 4096 and the
   LLaVA-1.6 grid pinpoints: ``Generator.generate_anyres`` at B=2 on a
   672x672 and a 1008x336 image (2928 and 2328 merged image tokens; the
   tiles through the tower at B = 5 and 4), 32 new tokens, dense and
   sparse, and each image alone at B=1; ``s2_tower_features`` at scales
   336 / 672 / 1008; TokenPacker's tower taps (12, 16, 22, 23) and
   projector at raw grid 24, scale factor 2; ``preprocess_batch`` on two
   uint8 480x640 frames. Holds: the merged counts equal the host's
   ``merge_anyres_features`` on the images' geometry; the dense prefill's
   last logits and the first 4 decode steps' within ``logits_hold``'s
   bf16 bound of ``run_layers_nocache`` + ``lm_head`` over the same fused
   embeddings and tokens; each row's tokens at B=2 equal its tokens at
   B=1 or leave them at a near tie (``explain_divergence``); S2's first
   channel block bit for bit the tower's; TokenPacker's output [1, 144,
   4096] and finite; preprocessing within ``tests/test_preprocess.py``'s
   bounds of the PIL pipeline. The ``hires`` line (token counts, prefill
   ms, seconds, the holds' numbers, wrapper calls, peak GiB);
6. quantized serving at 7B width on the first QUANT_DEPTH (16) of 32
   layers (views; cut for the script's time limit), the same batches: the
   phase-5 weights quantized in place to int8 (``quantize_llm_params``),
   sparse and dense; then an int4 decoder made directly (32 layers,
   ``init_quantized_llama_params``) beside the bf16 tower, projector and
   predictors, sparse;
7. lean-memory serving at 7B width on the first LEAN_DEPTH of the int4
   decoder's 32 layers (views of its stacked weights; cut for the script's
   time limit), the same batches, within one process so that the modes can
   be compared: bf16 KV with the
   fused MLP (K9, ``DYNAMIC_LLAVA_Q4_MLP=1``) off, on, on, off; fused with
   an int8 KV cache, sparse and dense; fused with an fp8 cache, sparse;
   then ring overflow (int8 KV, 256 new tokens at a decode window of 64,
   so both tiers wrap). On the card K9 must launch once per layer and
   decode step with the switch on and never with it off, K2 once per layer
   and step in every mode. Cache bytes and peak memory are printed. Then
   the KV cosine (``kv_cosine``) on all 32 layers: the bf16-KV run's
   greedy tokens fed to an int8-KV and an fp8-KV run (teacher forcing,
   B=8), the cosine of each
   sample's last logits against bf16 KV's at decode steps 1, 16 and 64
   (the ``kv_cosine`` line), every one finite;
8. LLaVA-1.5-13B width (hidden 5120, ffn 13824) on DEPTH_13B of its 40
   layers (cut for the script's time limit), an int4 decoder made directly,
   fused MLP, B=1, 256 new tokens, sparse and dense;
9. training at 7B width (TRAIN_DEPTH decoder layers, fresh random bf16
   weights): ``Trainer.train`` over TRAIN_STEPS sparse steps (B=4, one
   336x336 image + 1088 text tokens each, half of them labels, fused
   S = 1663), then as many dense-stage steps on the same weights; the
   launch counters of K1, K3 (all three kernels) and K4 are zeroed before each
   and must equal the counts the layer layout implies; the loss must be
   finite and the parameters changed;
9b. the remat policies ``nothing``, ``dots``, ``flash``, ``flash_dots`` and
   ``alternate`` at 7B width (``remat_policies``): the first step's
   gradients on ``REMAT_CHECK_DEPTH`` layers equal ``nothing``'s for every
   policy (the same fresh weights, batch and noise); then REMAT_STEPS
   sparse steps each at the largest of ``REMAT_DEPTHS`` that fits, K1 (the
   CLIP tower's apart), K3 and K4 counted: once a layer and step under the
   ``flash`` policies and ``alternate`` (F2: the forward's outputs are
   saved), twice under ``nothing`` and ``dots`` (the ``remat`` line);
9c. QLoRA at 7B width (``qlora``): an int4 decoder with rank-128 adapters
   on all seven targets, ``lora_mode``, REMAT_STEPS sparse steps: the loss
   finite, the base byte-equal, every adapter's B moved; then ``generate``
   with the adapters (B=8, 16 tokens, the fused-MLP switch on): K7 / K8
   launch, K9 never, the tokens equal an eager loop's (the ``qlora``
   line).
9d. the training CLI at 7B width (``train_cli``): ``train_sparse.train``
   in this process, ``--model_size 7b`` (32 layers, bf16, random weights
   from its seed), B=4, CLI_STEPS sparse steps over a LLaVA-format JSON set
   the phase writes (12 records with a PNG of mixed aspect ratio through the
   ``pad`` path, native where ``g++`` builds it; 4 text-only; ~1.6k fused
   tokens each) and a word-level tokenizer it writes, then the CLI's final
   save (~38 GiB; the room checked first, the directory removed after);
   K1 / K3 / K4 held to phase 9's sparse step, losses finite, the
   checkpoint file present (the ``train_cli`` line: step ms, fused lengths,
   peak, save seconds and bytes, whether the native image path ran);
10. the other families at 7B width on the first FAMILY_DEPTH (8) of 32
   layers, random bf16 weights (``families``): Mistral-7B (GQA 32 / 8,
   window 4096), dense, ``Generator.generate`` on text prompts of 4608
   tokens (the window binds in the prefill, on the plain path, and in K2)
   and 2048 (K1 at GQA 32 / 8), 32 new tokens each, the prefill's and
   every decode step's logits within ``logits_hold``'s bound of
   ``llama.forward_dense`` over prompt + tokens, and without the window
   the rows past it outside that bound; MPT-7B (d_model 4096, 32 heads,
   vocab 50368): one image + text prompt through ``mpt.forward_multimodal``,
   finite, and ``mpt.generate_greedy``'s 32 tokens each the teacher-forced
   argmax or at a near tie; a tiny MPT checkpoint through
   ``load_pretrained_model`` gives an ``MptRuntime`` with the saved
   weights. The ``families`` line.

After the main path of each serving mode, outside its counts and trace,
TIMED more batches are timed (the graph is reused), each followed by its
prefill timed again alone; with the medians of both, TTFT is the prefill's
and decode tok/s is ``B * 64 / (batch time - TTFT)``. The
decode step walls of the graph and of the eager loop are both host clock
around the decode steps alone after a prefill (``graph_decode``,
``eager_decode``). A train step is timed on the host clock after
``synchronize``, the first apart. The last two lines of standard output
are a JSON object with each kernel's error, times, bound (the larger of
its bytes over 3.35 TB/s and its operations over the card's peak for its
input type, from this run's inputs), launches (on the card, from the
trace: a GEMV wrapper and its group form launch one kernel, whose count
both report) and wrapper calls, and ``{"ok": true, "device": {...}}``.
Before them a ``decode_graph`` line gives, per serving mode, the decode
step wall of the eager loop and of the graph, the capture's ms and
whether the tokens were equal, and a ``chat`` line each chat mode's TTFT,
continuation ms, decode tok/s, capture ms, peak GiB and decode steps, and
a ``continuous`` line with phase 5d's arms, and a ``checkpoint`` line with
phase 5e's, a ``train_cli`` line with phase 9d's and a ``serving`` line with
phase 5f's and the ``ppl_tools`` and ``bench_core`` lines with phase 5g's,
the ``hires`` line with phase 5h's and the ``families`` line with phase
10's (whose wrapper calls, as phase 5f's and 5g's, join the ``kernels``
line's). K1's, K2's, K2-M's
and the int8 GEMV's launches in the ``kernels`` line include the engines'
traced passes and phase 5e's; K1's, K3's and K4's include phase 9d's.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
BF16_TOL = 2e-2
FP32_TOL = 1e-4
TRAIN_DEPTH = 32  # decoder layers of the training phase (width is never cut)
# decoder layers of phase 7's serving modes (of the int4 decoder's 32): cut
# so that the script, with phase 5e's generators and phase 9d, stays inside
# its 1200 s limit; its KV cosine keeps full depth
LEAN_DEPTH = 8
# decoder layers of phase 5b's chat modes (of the phase-5 decoder's 32): cut
# so that the script, with phase 5f, stays inside its 1200 s limit
CHAT_DEPTH = 16
# decoder layers of phase 5c's speculative arms and beam search and of phase
# 5d's continuous-batching arms (of the phase-5 decoder's 32), and of phase
# 8's 13B decoder (of its 40): cut so that the script keeps a wide margin
# inside its 1200 s limit
SPEC_DEPTH = 16
CONT_DEPTH = 16
DEPTH_13B = 10
# decoder layers of the checkpoint path (phases 5e-5g: the export, the loads
# and everything served from them) and of phase 6's quantized serving modes
# (of the phase-5 / int4 decoders' 32): cut so that the script, with phases
# 5h and 10, stays inside ~950 s; phase 5's bf16 serving, 5h, the KV cosine
# and training keep full depth
CKPT_DEPTH = 16
QUANT_DEPTH = 16
TRAIN_STEPS = 3  # per mode; the first is timed apart
TRAIN_BATCH, TRAIN_TEXT_LEN = 4, 1088  # fused S = 1088 - 1 + 576 = 1663
TIMED = 3  # timed generate calls and prefills a serving mode
CHAT_MAX_NEW = 64  # new tokens a chat round
CHAT_CHUNKS = (40, 100)  # tokens of rounds 2 and 3
CHAT_BUDGET = 384  # new tokens (answers and chunks) a chat session has room for
SPEC_MAX_NEW = 128  # new tokens a speculative generation
SPEC_KS = (4, 7)  # draft lengths k (M = k + 1 candidates a verify round)
SPEC_EAGER_ROUNDS = 16  # rounds the graph runner is held to an eager loop over
BEAM_W, BEAM_NEW = 4, 16  # beams and new tokens of the beam search
CONT_SLOTS, CONT_CHUNK, CONT_BUCKET = 8, 16, 640  # engine slots, steps a chunk, prompt bucket
CONT_REQUESTS, CONT_ARRIVAL_S = 16, 0.3  # the trace: requests, seconds between arrivals
CONT_MAX_NEW = (64, 128)  # new tokens, alternating
CONT_SAMPLED = (5, 10)  # requests that sample (temperature 0.8, top-p 0.9) where an arm samples
CONT_SPEC_K = 4
# phase 5e: the checkpoint round trip and the entry points
CKPT_QUESTIONS, CKPT_MAX_NEW, CKPT_SPEC_K = 3, 32, 4  # VQA questions, new tokens an answer, k
CKPT_TURNS = ("What is in the image ?", "Is there a dog ?")  # the chat CLI's two rounds
# phase 5f: serving over HTTP on phase 5e's checkpoint
SERVE_MAX_NEW = 64  # new tokens a request
SERVE_REQUESTS = 8  # requests sent at once to the batched workers
SERVE_SENDS, SERVE_SPEC_SENDS = 4, 2  # greedy requests to the model worker, to its --spec-k form
SERVE_SPEC_K, SERVE_SLOTS, SERVE_WINDOW_MS = 4, 4, 100
CKPT_NAME = "llava-v1.5-7b-random"  # phase 5e's checkpoint directory: the model name served
# phase 5g: the generation-quality probes on phase 5e's checkpoint (fp32) and
# the bench core on the phase-5 weights at phase 5's batch shape (B=8, an
# image + 64 text tokens: 640 fused)
PPL_SIZES = dict(max_new=32, answer_words=32, round_words=12, rounds=3,
                 bench_batch=8, bench_text=65, bench_new=64, bench_reps=3,
                 long_new=64, long_every=32)
PPL_RTOL = 1e-3  # the dense teacher-forced PPL against one forward pass, fp32
# phase 4b: the quality gates at the JAX tests' configs (text hidden 64 in 4
# heads, a tower of hidden 32 in 2 heads: head_dim 16, which the attention
# wrappers zero-pad to 64), fp32, seed 0, at the JAX tests' step counts
GATE_VISION_STEPS = 150  # dense, then as many sparse
GATE_TEXT_STEPS = (300, 400)  # dense, sparse
GATE_CHAIN_STEPS = 40
GATE_CHECK_STEPS = 5  # training steps of each stage held card against CPU
COSINE_STEPS = (1, 16, 64)  # phase 7: decode steps at which the KV modes' logits are compared
# phase 9b / 9c: the JAX package's remat policies and QLoRA at 7B width
REMAT_POLICIES = ("nothing", "dots", "flash", "flash_dots", "alternate")
REMAT_STEPS = 2  # per policy; the first is timed apart
REMAT_DEPTHS = (32, 24, 16, 8)  # tried in turn until a policy's steps fit the card
REMAT_CHECK_DEPTH = 4  # the gradient check's depth (the same weights for every policy)
LORA_RANK, LORA_ALPHA = 128, 256.0  # run/finetune_qlora.sh's adapters
# phase 9d: the training CLI on a JSON set the phase writes
CLI_STEPS = 3
CLI_IMAGE_RECORDS, CLI_TEXT_RECORDS = 12, 4
CLI_WORDS, CLI_TURN_WORDS = 4000, 250  # synthetic vocabulary; words a turn (~1.6k fused)
CLI_IMAGE_SIZES = ((640, 480), (480, 640), (336, 336), (800, 300), (300, 800), (500, 375),
                   (375, 500), (1024, 768), (448, 336), (336, 448), (700, 350), (350, 700))
# published peaks of one H100 SXM (NVIDIA's data sheet)
HIRES_PINPOINTS = [[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]]
HIRES_SIZES = ((672, 672), (1008, 336))  # (width, height) of phase 5h's two images
HIRES_MAX_NEW = 32
HIRES_CHECK_STEPS = 4  # decode steps whose logits hold (b) besides the prefill's
S2_SCALES = (336, 672, 1008)
TP_LAYERS = (12, 16, 22, 23)  # TokenPacker's tower taps
# phase 10's 7B-width families run their first 8 of 32 layers (the script's
# time limit; neither hold depends on depth)
FAMILY_DEPTH = 8
MISTRAL_PROMPTS = (4608, 2048)  # past the 4096 window, and inside it
FAMILY_MAX_NEW = 32
# the cached paths' logits against the no-cache forward's, relative to the
# largest: 16 bf16 units of roundoff (``logits_hold``)
LOGITS_HOLD_REL = 2.0**-4
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(msg: str) -> None:
    """A phase's first line, with the seconds since the script started and,
    once the port is imported, the launch-counting traces taken so far and
    the seconds they cost beyond the calls they wrapped."""
    cost = ""
    kc = sys.modules.get("dynamic_llava_tpu_torch.kernel_cases")
    if kc is not None:
        cost = (f"; {kc.TRACE_COST['traces']} traces, {kc.TRACE_COST['records']} kernel records, "
                f"{kc.TRACE_COST['seconds']:.0f} s of trace cost")
    log(f"{msg} [at {time.perf_counter() - T0:.0f} s{cost}]")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def use_kineto_config() -> None:
    """Point kineto (the backend of ``torch.profiler``) at the port's
    ``kineto.conf`` before torch is imported; a ``KINETO_CONFIG`` already set
    is kept. The file raises kineto's cap on one trace's GPU records from
    128 MB to 1 GB: a traced 256-step decode call at B=8 records ~108 MB,
    and past the cap kineto stops collecting, so the trace loses its end."""
    import os

    os.environ.setdefault(
        "KINETO_CONFIG", str(ROOT / "dynamic_llava_tpu_torch" / "kineto.conf"))


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, replayed from one CUDA
    graph (so the Python launch cost of a small kernel does not pace the
    card), timed with CUDA events after a warm-up replay. A list of
    functions is called in turn."""
    import torch

    from dynamic_llava_tpu_torch.generation.generate import capturing

    fns = fn if isinstance(fn, list) else [fn]
    for f in fns[:2]:  # builds, sets kernel attributes, warms the allocator
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with capturing(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def time_events_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` eager calls after two
    warm-up calls (for calls that do not capture into a CUDA graph)."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms_by_name(fn, iters: int = 5) -> dict:
    """Mean device time a call of ``fn`` spends in each kernel, by kernel
    name, from ``torch.profiler`` over ``iters`` eager calls after a
    warm-up call (for a wrapper that launches more than one kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    require(out, "the profiler saw no device time")
    return out


def bound_ms(nbytes: float, flops: float, kind: str = "bf16"):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak for the input type.
    Returns (ms, "bytes" | "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attended_pairs(b: int, sq: int, sk: int, causal: bool, lens=None) -> int:
    """(query row, kv column) pairs the masks leave, summed over the batch."""
    total = 0
    for i in range(b):
        n = sk if lens is None else max(0, min(int(lens[i]), sk))
        if causal:
            full = max(0, sq - n)  # rows that see all n columns
            tri = min(sq, n)
            total += tri * (tri + 1) // 2 + full * n
        else:
            total += sq * n
    return total


def sdpa_layout(t):
    """[B, S, H, d] -> contiguous [B, H, S, d], the library call's layout."""
    return t.transpose(1, 2).contiguous()


def check_kernels(torch):
    """Phase 3, K1: the flash forward against its plain version at every
    ``kernel_cases.FLASH_FWD_CASES`` case (main-path shapes and the edges of
    its tiles, bf16 and fp32), each launched twice for equal bits; timed at
    the decoder's pre-tier and the CLIP tower's shapes. Returns its results
    (max error over all cases, times at the decoder shape)."""
    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    import torch.nn.functional as F

    dev = torch.device("cuda")
    res = {"flash_attention_fwd": {"max_abs_err": 0.0}}
    for case in kc.FLASH_FWD_CASES:
        try:
            err, lse_err = kc.check_flash_fwd_case(case, dev)
        except AssertionError as e:
            raise RuntimeError(str(e)) from e
        tol = kc.FP32_TOL if case.dtype == torch.float32 else kc.BF16_TOL
        log(f"  K1 {case.label} {kc.describe_flash_case(case)}: max_abs_err={err:.3e}, lse "
            f"{lse_err:.3e} (atol=rtol={tol:g}), two launches equal: ok")
        res["flash_attention_fwd"]["max_abs_err"] = max(
            res["flash_attention_fwd"]["max_abs_err"], err)
        if case.label not in ("decoder pre tier", "clip tower") + kc.TIMED_FLASH_SHAPES:
            continue
        q, k, v, _, kvl = kc.make_flash_inputs(case, dev)
        b, s, h, d = q.shape
        causal, lens = case.causal, case.lengths
        gqa = dict(enable_gqa=True) if case.hkv != h else {}
        # the longest shapes' plain versions hold GiBs of fp32 scores a call
        iters = 20 if b * h * s * s <= 2**28 else 3
        kms = time_ms(lambda: flash_attention(q, k, v, kv_length=kvl, causal=causal))
        pms = time_ms(lambda: flash_attention_plain(q, k, v, kv_length=kvl, causal=causal),
                      iters)
        # yardstick: one SDPA call on the same inputs, the masks as a bool mask
        ql, kl, vl = sdpa_layout(q), sdpa_layout(k), sdpa_layout(v)
        cols = torch.arange(s, device=dev)
        mask = torch.ones((b, 1, s, s), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (cols[None, :] <= cols[:, None])
        if kvl is not None:
            mask = mask & (cols[None, :] < kvl[:, None])[:, None, None, :]
        lms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, **gqa))
        # the bool mask keeps SDPA off its flash backend: also at full
        # lengths without a mask tensor, the kernel on the same inputs
        full_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal))
        lfull_ms = time_ms(
            lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, **gqa))
        pairs = attended_pairs(b, s, s, causal, lens)
        bms, bby = bound_ms(2 * (2 * q.numel() + 2 * k.numel()), 4 * pairs * d * h)
        log(f"  K1 {case.label} time: kernel {kms:.4f} ms, plain {pms:.4f} ms, SDPA "
            f"(bool mask) {lms:.4f} ms, bound {bms:.4f} ms ({bby}); every sample at "
            f"full length: kernel {full_ms:.4f} ms, SDPA is_causal={causal} "
            f"{lfull_ms:.4f} ms")
        timing = dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=bby,
                      full_length_ms=full_ms, library_full_length_ms=lfull_ms)
        if case.label == "decoder pre tier":
            res["flash_attention_fwd"].update(timing)
        elif case.label == "clip tower":
            res["flash_attention_fwd"]["clip"] = timing
        else:
            res["flash_attention_fwd"].setdefault("shapes", {})[
                f"{case.label} B={b} S={s} H={h} Hkv={case.hkv} d={d}"] = timing

    torch.cuda.synchronize()
    return res


def check_decode_kernel(torch):
    """Phase 3, K2: every ``kernel_cases.DECODE_CASES`` case (bf16, fp32,
    scaled-int8 and fp8 storage; lengths 0, 1, at the edges of the kernel's
    tiles and splits, at the capacity and past it; a window, also inside a
    split; head_dim 64 and 128; 1-8 query heads a kv head; B = 8) against
    the plain version in fp32 on the same stored values, each launched twice
    for equal bits. Times (CUDA events over a graph replay) at max_len 768
    and 256 with every sample one row short of the capacity, B = 4 (the
    table's shapes) and B = 8, beside one SDPA call over the live rows (for
    int8 / fp8 storage: on the dequantized bf16 cache). Returns the kernel's
    results: max errors, the bf16 times at B = 4, max_len 768, and the other
    readings under ``int8`` / ``fp8`` / ``shapes``."""
    import torch.nn.functional as F

    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain)
    from dynamic_llava_tpu_torch.ops.kv_cache import dequantize_kv

    dev = torch.device("cuda")
    res = {"max_abs_err": 0.0, "int8": {"max_abs_err": 0.0}, "fp8": {"max_abs_err": 0.0},
           "shapes": {}}
    before = decode_attention.launches
    for case in kc.DECODE_CASES:
        try:
            err = kc.check_decode_case(case, dev)
        except AssertionError as e:
            raise RuntimeError(str(e)) from e
        tol = kc.FP32_TOL if case.dtype == torch.float32 else kc.BF16_TOL
        log(f"  {kc.describe_decode_case(case)}: max_abs_err={err:.3e} (atol=rtol={tol:g}), "
            "two launches equal: ok")
        top = res[case.storage] if case.storage in res else res
        top["max_abs_err"] = max(top["max_abs_err"], err)
    require(decode_attention.launches == before + 2 * len(kc.DECODE_CASES),
            "K2 launch counter")

    for b, max_len, storage in [(4, 768, "own"), (4, 768, "int8"), (4, 768, "fp8"),
                                (4, 256, "own"), (8, 768, "own"), (8, 768, "int8"),
                                (8, 256, "own"), (8, 256, "int8")]:
        n_live, h, d, dtype = max_len - 1, 32, 128, torch.bfloat16
        case = kc.DecodeCase("timing", b, max_len, h, h, d, dtype, storage, (n_live,) * b)
        (q, kc_, vc, kn, vn, live), kw = kc.make_decode_inputs(case, dev, SEED + 3)
        kms = time_ms(lambda: decode_attention(q, kc_, vc, kn, vn, live, **kw), 100)
        pms = time_ms(lambda: decode_attention_plain(q, kc_, vc, kn, vn, live, **kw), 100)
        ks, vs = kw["k_scale"], kw["v_scale"]
        kd = dequantize_kv(kc_, ks, dtype) if ks is not None else kc_.to(dtype)
        vd = dequantize_kv(vc, vs, dtype) if vs is not None else vc.to(dtype)
        ql = sdpa_layout(q)
        kl = sdpa_layout(torch.cat([kd[:, :n_live], kn], dim=1))
        vl = sdpa_layout(torch.cat([vd[:, :n_live], vn], dim=1))
        lms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl), 100)
        # bytes: the live cache rows in their storage type (int8: and their
        # bf16 scales), q, the current K/V and the output in q's type
        per_elem = 2 if storage == "own" else 1
        cache = 2 * b * n_live * h * (d * per_elem + (2 if storage == "int8" else 0))
        bms, bby = bound_ms(cache + 2 * (2 * q.numel() + 2 * b * h * d),
                            4 * b * (n_live + 1) * h * d)
        log(f"  K2 time, B={b} max_len={max_len}, {storage} cache, every sample at length "
            f"{n_live}: kernel {kms:.4f} ms, plain {pms:.4f} ms, SDPA"
            f"{'' if storage == 'own' else ' on the dequantized bf16 cache'} {lms:.4f} ms, "
            f"bound {bms:.4f} ms ({bby})")
        timing = dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=bby)
        if (b, max_len) == (4, 768):
            (res if storage == "own" else res[storage]).update(timing)
        else:
            res["shapes"][f"B={b} max_len={max_len} {storage}"] = timing

    # Mistral past its window: GQA 32 / 8, only the window's rows are read
    case = next(c for c in kc.DECODE_CASES if c.label == "mistral window")
    (q, kc_, vc, kn, vn, live), kw = kc.make_decode_inputs(case, dev, SEED + 3)
    kms = time_ms(lambda: decode_attention(q, kc_, vc, kn, vn, live, **kw), 100)
    pms = time_ms(lambda: decode_attention_plain(q, kc_, vc, kn, vn, live, **kw), 100)
    n_live, q_pos = case.lengths[0], int(kw["q_pos"][0])
    first = max(0, q_pos - case.window + 1)  # the window's first cache row
    rows = n_live - first
    ql = sdpa_layout(q)
    kl = sdpa_layout(torch.cat([kc_[:, first:n_live], kn], dim=1))
    vl = sdpa_layout(torch.cat([vc[:, first:n_live], vn], dim=1))
    lms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, enable_gqa=True), 100)
    b, h, hkv, d = case.b, case.h, case.hkv, case.d
    bms, bby = bound_ms(2 * b * rows * hkv * d * 2 + 2 * (2 * q.numel() + 2 * kn.numel()),
                        4 * b * (rows + 1) * h * d)
    log(f"  K2 time, Mistral window: B={b} H={h} Hkv={hkv} max_len={case.max_len}, length "
        f"{n_live}, window {case.window} ({rows} cache rows read): kernel {kms:.4f} ms, "
        f"plain {pms:.4f} ms, SDPA over the window's rows {lms:.4f} ms, bound {bms:.4f} ms "
        f"({bby})")
    res["shapes"][f"mistral window B={b} H={h} Hkv={hkv} max_len={case.max_len} "
                  f"length {n_live} window {case.window}"] = dict(
        ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=bby)
    torch.cuda.synchronize()
    return res


def check_extend_kernel(torch):
    """Phase 3, K2-M (the M-query form of K2): every
    ``kernel_cases.EXTEND_CASES`` case (bf16, fp32, scaled-int8 and fp8
    storage; M x n_rep across the tensor-core form's 16- and 64-row tiles
    and the CUDA-core form's groups of 8 query rows; 1, 4 and 8 query heads
    a KV head; head_dim 64 and 128; B = 1-4 with ragged lengths at 0, the
    tile and split edges and the capacity; a chunk_attend mask, all false
    too, and a window, also across a tile's rows; the speculative verify
    shapes) against the plain version in fp32 on the same stored values,
    each launched twice for equal bits; then every case once more in one
    profiler trace, which must show ``extend_mma_kernel`` for each bf16-q
    case and ``extend_kernel`` for each fp32 one. Times (CUDA events over a
    graph replay) at the
    chat phase's shapes: B=1, H=Hkv=32, d=128, the pre tier of 1088 slots,
    M=40 at length 700 and M=100 at 804 (rounds 2 and 3), bf16 and int8
    storage, and at ``kernel_cases.VERIFY_CASES`` (phase 5c's verify rounds),
    beside one SDPA call on the cache rows up to the longest length and the
    chunk concatenated (on the dequantized bf16 cache for int8) with the
    same mask as a bool tensor. Returns the results: max errors, the bf16
    M=40 times, and the other readings under ``shapes`` by case label."""
    import torch.nn.functional as F

    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.ops.decode_attention import extend_attention, extend_mask
    from dynamic_llava_tpu_torch.ops.kv_cache import dequantize_kv

    dev = torch.device("cuda")
    res = {"max_abs_err": 0.0, "int8": {"max_abs_err": 0.0}, "fp8": {"max_abs_err": 0.0},
           "shapes": {}}
    for case in kc.EXTEND_CASES:
        try:
            err = kc.check_extend_case(case, dev)
        except AssertionError as e:
            raise RuntimeError(str(e)) from e
        tol = kc.FP32_TOL if case.dtype == torch.float32 else kc.BF16_TOL
        log(f"  {kc.describe_extend_case(case)}: max_abs_err={err:.3e} (atol=rtol={tol:g}), "
            "two launches equal: ok")
        top = res[case.storage] if case.storage in res else res
        top["max_abs_err"] = max(top["max_abs_err"], err)
    try:
        ran = kc.check_extend_dispatch(kc.EXTEND_CASES, dev)
    except AssertionError as e:
        raise RuntimeError(str(e)) from e
    log(f"  K2-M kernels on the card, one launch a case: {ran} (tensor cores for a bf16 q)")

    # the chat shapes (rounds 2 and 3) and the speculative verify shapes
    for case in kc.EXTEND_CASES[:4] + kc.VERIFY_CASES:
        args, kw = kc.make_extend_inputs(case, dev, SEED + 4)
        q, kc_, vc, kn, vn, live = args
        b, m, h, d, dtype, storage = case.b, case.m, case.h, case.d, case.dtype, case.storage
        kms = time_ms(lambda: extend_attention(*args, **kw), 50)
        pms = time_ms(lambda: kc.extend_plain(*args, **kw), 10)
        # SDPA on the cache rows up to the longest length and the chunk,
        # concatenated, under the same mask as a bool tensor
        n_max = max(case.lengths)
        ks, vs = kw["k_scale"], kw["v_scale"]
        kd = dequantize_kv(kc_, ks, dtype) if ks is not None else kc_
        vd = dequantize_kv(vc, vs, dtype) if vs is not None else vc
        ql = sdpa_layout(q)
        kl = sdpa_layout(torch.cat([kd[:, :n_max], kn], dim=1))
        vl = sdpa_layout(torch.cat([vd[:, :n_max], vn], dim=1))
        mask = extend_mask(live, n_max, m, chunk_attend=kw.get("chunk_attend"))
        lms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask), 50)
        # bytes: the live cache rows in their storage type (int8: and their
        # bf16 scales), q, the chunk's K/V and the output; operations: two
        # products over every attended (row, column) pair
        per_elem = 2 if storage == "own" else 1
        cache = sum(2 * n * h * (d * per_elem + (2 if storage == "int8" else 0))
                    for n in case.lengths)
        pairs = int(mask.sum())
        bms, bby = bound_ms(cache + 2 * (2 * q.numel() + 2 * kn.numel()), 4 * pairs * h * d)
        # each row tile (tensor cores) or group of 8 rows (CUDA cores) of a
        # kv head reads the cache once
        plan = kc.extend_case_plan(case)
        reads = plan.row_tiles
        log(f"  K2-M time, {case.label}: B={b} M={m} H=Hkv={h} d={d} max_len={case.max_len}, "
            f"{storage} cache at lengths {list(case.lengths)}, chunk_attend={case.attend}: "
            f"kernel {kms:.4f} ms, plain {pms:.4f} ms, SDPA on the concatenated"
            f"{'' if storage == 'own' else ' dequantized'} K/V with a bool mask {lms:.4f} ms, "
            f"bound {bms:.4f} ms ({bby}); the cache is read by {reads} "
            f"{'row tiles of 64' if plan.tensor_cores else 'row groups of 8'} "
            f"({plan.n_split} splits): {reads * cache / kms / 1e6:.0f} GB/s of cache reads")
        timing = dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=bby,
                      cache_reads=reads)
        if case is kc.EXTEND_CASES[0]:
            res.update(timing)
        else:
            res["shapes"][case.label] = timing
    torch.cuda.synchronize()
    return res


def check_quant_kernels(torch):
    """Phase 3, K5-K8: each GEMV against its plain version on the same
    bf16 x and int8 / packed int4 weights (bf16 scales), at every
    ``kernel_cases.QUANT_CASES`` shape and ``QUANT_ROWS`` row count and at
    the ``QUANT_EDGE_CASES`` (a three-weight group of unequal widths, widths
    and K that end inside a tile, a k16 step or a unit, the 13B shapes,
    widths that are not a multiple of 64, fp32 x),
    each launched twice for equal bits. Times (CUDA events over a graph
    replay) rotate through weight copies of more than 256 MB, so that every
    call reads its weights from HBM as a decode step does; beside them the
    plain version and ``@`` on the dequantized bf16 weight, on one copy (as
    every earlier run timed it: up to 50 MB of it stay in the L2) and, at
    rows 8, rotated like the kernel's. Returns per-kernel results: max
    errors over all cases, times at rows 8 of the largest shape, and every
    shape's readings under ``shapes``."""
    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {name: {"max_abs_err": 0.0, "max_err_rel": 0.0, "shapes": {}}
           for name in ("q8_gemv", "q8_gemv_group", "q4_gemv", "q4_gemv_group")}

    def check(case, bits, rows, weights, scales):
        name = kc.gemv_functions(bits, len(case.ns) > 1)[0]
        try:
            err, rel = kc.check_gemv_case(case, bits, rows, dev, gen, weights, scales)
        except AssertionError as e:
            raise RuntimeError(str(e)) from e
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        res[name]["max_err_rel"] = max(res[name]["max_err_rel"], rel)
        return (f"  {name} int{bits} {case.label} [K={case.k} N={'+'.join(map(str, case.ns))} "
                f"rows={rows}{' fp32 out' if case.out_fp32 else ''}"
                f"{' fp32 x' if case.x_fp32 else ''}]: max_abs_err={err:.3e}, /max|ref| "
                f"{rel:.3e} (tol {kc.QUANT_TOL[case.out_fp32 or case.x_fp32]:g}), two "
                "launches equal: ok")

    for bits in (8, 4):
        for case in kc.QUANT_EDGE_CASES:
            (weights,), scales = kc.make_gemv_weights(case, bits, dev, gen)
            for rows in kc.QUANT_EDGE_ROWS:
                log(check(case, bits, rows, weights, scales))
        for case in kc.QUANT_CASES:
            name, kernel, plain = kc.gemv_functions(bits, len(case.ns) > 1)
            nbytes = case.k * sum(n // 2 if bits == 4 else n for n in case.ns)
            copies = max(2, -(-(256 << 20) // nbytes))
            weights, scales = kc.make_gemv_weights(case, bits, dev, gen, copies)
            for rows in kc.QUANT_ROWS:
                line = check(case, bits, rows, weights[0], scales)
                x = torch.randn(rows, case.k, generator=gen, device=dev).bfloat16()
                kms = time_ms([lambda ws=ws: kc.call_gemv(kernel, case, x, ws, scales)
                               for ws in weights], 30)
                pms = time_ms([lambda ws=ws: kc.call_gemv(plain, case, x, ws, scales)
                               for ws in weights[:2]], 10)

                def dequantized(ws):
                    return [(qm.unpack_int4(w) if bits == 4 else w).bfloat16() for w in ws]

                deq = dequantized(weights[0])
                mms = time_ms(lambda: [x @ w for w in deq], 10)
                line += (f"; kernel {kms:.4f} ms ({nbytes / kms / 1e6:.0f} GB/s of weights), "
                         f"plain {pms:.4f} ms, bf16 matmul on the dequantized weight (one "
                         f"copy) {mms:.4f} ms")
                shape = dict(ms=kms, plain_ms=pms, library_ms=mms)
                if rows == 8:  # the yardstick on cold weights too
                    deqs = [deq] + [dequantized(ws) for ws in weights[1:]]
                    cold = time_ms([lambda d=d: [x @ w for w in d] for d in deqs], 30)
                    del deqs
                    io = 2 * sum(sc.numel() for sc in scales) + 2 * x.numel() + \
                        (4 if case.out_fp32 else 2) * rows * sum(case.ns)
                    bms, bby = bound_ms(nbytes + io, 2 * rows * case.k * sum(case.ns))
                    line += (f", rotated through {copies} copies {cold:.4f} ms; bound "
                             f"{bms:.4f} ms ({bby})")
                    shape.update(library_cold_ms=cold, bound_ms=bms, bound_by=bby)
                    # the JSON line's required keys: the decode step's largest GEMVs
                    if case.label == ("gate/up" if len(case.ns) > 1 else "down"):
                        res[name].update(shape, shape=f"{case.label} rows 8")
                del deq
                log(line)
                res[name]["shapes"][f"{case.label} rows {rows}"] = shape
            del weights
    torch.cuda.synchronize()
    return res


def check_mlp_kernel(torch):
    """Phase 3, K9: the fused int4 MLP against ``q4_mlp_plain`` on the same
    x, packed weights and bf16 scales at every ``kernel_cases.MLP_CASES``
    shape and ``QUANT_ROWS`` row count and at the ``MLP_EDGE_CASES`` (F and D
    that end inside a tile, K inside a unit, unsliced phases) and
    ``MLP_EDGE_ROWS``, bf16 x (bf16 out) and fp32 x (fp32 out: the kernel
    rounds x to bf16 as the plain version does, so only the order of the fp32
    sums and the rare h that rounds the other way differ; at the main shapes
    both are also held against the same arithmetic in float64), each launched
    twice for equal bits. Times rotate through weight copies of more than 256
    MB. Beside the kernel: the two-kernel path it fuses (K8 gate/up + ``silu
    * mul`` + K7 down) and three ``@`` on dequantized bf16 weights + ``silu *
    mul``."""
    import torch.nn.functional as F

    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    res = {"max_abs_err": 0.0, "max_err_rel": 0.0, "shapes": {}}

    def check(case, rows, fp32, weights, scales):
        try:
            err, rel, x = kc.check_mlp_case(case, rows, fp32, dev, gen, weights, scales)
        except AssertionError as e:
            raise RuntimeError(str(e)) from e
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["max_err_rel"] = max(res["max_err_rel"], rel)
        return x, (f"  q4_mlp {case.label} [K={case.k} F={case.f} D={case.d} rows={rows} "
                   f"{x.dtype}]: max_abs_err={err:.3e}, /max|ref| {rel:.3e} (tol "
                   f"{kc.MLP_TOL[fp32]:g}), two launches equal: ok")

    for case in kc.MLP_EDGE_CASES:
        (weights,), scales = kc.make_mlp_weights(case, dev, gen)
        for rows in kc.MLP_EDGE_ROWS:
            for fp32 in (False, True):
                log(check(case, rows, fp32, weights, scales)[1])
    for case in kc.MLP_CASES:
        k, f = case.k, case.f
        nbytes = 3 * k * f // 2
        copies = max(2, -(-(256 << 20) // nbytes))
        weights, scales = kc.make_mlp_weights(case, dev, gen, copies)

        def two_kernels(x, ws):
            g, u = qm.q4_gemv_group(x, ws[:2], scales[:2])
            return qm.q4_gemv(F.silu(g) * u, ws[2], scales[2])

        def float64(x, ws):  # q4_mlp_plain's steps in float64
            xb, (sg, su, sd) = x.bfloat16().double(), (sc.double() for sc in scales)
            g = (xb @ qm.unpack_int4(ws[0]).double()) * sg
            u = (xb @ qm.unpack_int4(ws[1]).double()) * su
            h = (F.silu(g) * u).float().bfloat16().double()
            return (h @ qm.unpack_int4(ws[2]).double()) * sd

        for rows in kc.QUANT_ROWS:
            for fp32 in (False, True):
                x, line = check(case, rows, fp32, weights[0], scales)
                if fp32:
                    got = qm.q4_mlp(x, *weights[0], *scales, out_fp32=True)
                    want = qm.q4_mlp_plain(x, *weights[0], *scales, out_fp32=True)
                    r64 = float64(x, weights[0])
                    top = r64.abs().max().item()
                    line += (f"; against float64 /max|ref|: kernel "
                             f"{(got.double() - r64).abs().max().item() / top:.3e}, plain "
                             f"{(want.double() - r64).abs().max().item() / top:.3e}")
                    del r64, got, want
                    if rows != 8:
                        log(line)
                        continue
                kms = time_ms([lambda ws=ws: qm.q4_mlp(x, *ws, *scales, out_fp32=fp32)
                               for ws in weights], 30)
                log(line + f"; kernel {kms:.4f} ms ({nbytes / kms / 1e6:.0f} GB/s of weights)")
                if fp32:
                    continue
                two_ms = time_ms([lambda ws=ws: two_kernels(x, ws) for ws in weights], 30)
                log(f"    K8 gate/up + silu*mul + K7 down on the same inputs: {two_ms:.4f} ms "
                    f"(K9 {kms / two_ms:.2f}x)")
                shape = dict(ms=kms, two_kernel_ms=two_ms)
                if rows == 8:
                    pms = time_ms([lambda ws=ws: qm.q4_mlp_plain(x, *ws, *scales)
                                   for ws in weights[:2]], 5)
                    deq = [qm.unpack_int4(w).bfloat16() for w in weights[0]]
                    mms = time_ms(lambda: (F.silu(x @ deq[0]) * (x @ deq[1])) @ deq[2], 10)
                    del deq
                    io = 2 * sum(sc.numel() for sc in scales) + 2 * x.numel() + 2 * rows * k
                    bms, bby = bound_ms(nbytes + io, 6 * rows * k * f)
                    log(f"    rows 8: plain {pms:.4f} ms, three bf16 matmuls on the "
                        f"dequantized weights (one copy) + silu*mul {mms:.4f} ms, bound "
                        f"{bms:.4f} ms ({bby})")
                    shape.update(plain_ms=pms, library_ms=mms, bound_ms=bms, bound_by=bby)
                    res["shapes"][case.label] = dict(shape)
                res["shapes"][f"{case.label} rows {rows}"] = shape
        del weights
    res.update(res["shapes"]["7B"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


def check_train_kernels(torch):
    """Phase 3, K3 and K4: the flash backward (dq, dk, dv each) and the
    policy attention against their plain versions at the training shape,
    K3 also with GQA and a ``kv_length`` at a small size, and autograd
    through K1 + K3 against autograd through the plain forward. Returns
    per-kernel results (max error over all cases, times at the training
    shape in bf16)."""
    import torch.nn.functional as F

    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.ops import flash_attention as fa
    from dynamic_llava_tpu_torch.ops.flash_policy import (
        flash_policy_attention, flash_policy_attention_plain)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)

    def randn(*shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            dev, dtype)

    names = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv", "flash_policy_attention_fwd")
    res = {n: {"max_abs_err": 0.0} for n in names}

    # K3: every kernel_cases.FLASH_BWD_CASES case (the training shape and the
    # edges of the 64-row tiles, bf16 and fp32), twice for equal bits, with
    # the delta kernel against _delta; timed at the bf16 training shape
    require(kc.TRAIN_SHAPE.sq == TRAIN_TEXT_LEN - 1 + 576 and kc.TRAIN_SHAPE.b == TRAIN_BATCH,
            "kernel_cases.TRAIN_SHAPE is not phase 9's shape")
    for case in kc.FLASH_BWD_CASES:
        try:
            errs = kc.check_flash_bwd_case(case, dev)
        except AssertionError as e:
            raise RuntimeError(str(e)) from e
        tol = FP32_TOL if case.dtype == torch.float32 else BF16_TOL
        log(f"  K3 {case.label} {kc.describe_flash_case(case)}: max_abs_err dq "
            f"{errs['dq']:.3e}, dk {errs['dk']:.3e}, dv {errs['dv']:.3e} (atol=rtol={tol:g}), "
            f"delta {errs['delta']:.3e} (atol=rtol={FP32_TOL:g}), two launches equal: ok")
        for name, key in (("flash_attention_bwd_dq", "dq"), ("flash_attention_bwd_dkv", "dk"),
                          ("flash_attention_bwd_dkv", "dv")):
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], errs[key])
        res["flash_attention_bwd_dq"]["delta_max_abs_err"] = max(
            res["flash_attention_bwd_dq"].get("delta_max_abs_err", 0.0), errs["delta"])
        if case != kc.TRAIN_SHAPE:
            continue
        q, k, v, g, _ = kc.make_flash_inputs(case, dev, seed=1)
        b, s, h, d = q.shape
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        delta = fa.flash_attention_bwd_delta(out, g)
        delta_ms = time_ms(lambda: fa.flash_attention_bwd_delta(out, g), 20)
        delta_plain_ms = time_ms(lambda: fa._delta(out, g), 5)
        # yardstick of the delta kernel: rowsum(dO * O) as one PyTorch call, on
        # the fp32 values the kernel forms from its bf16 inputs
        of, gf = out.float(), g.float()
        delta_lib_ms = time_ms(lambda: torch.linalg.vecdot(gf, of, dim=-1), 20)
        del of, gf
        dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta), 5)
        dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta), 5)
        all_ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, g), 5)
        pms = time_events_ms(
            lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, g), 3)
        # yardstick: the backward of one SDPA call on the same inputs
        ql, kl, vl = (sdpa_layout(t).requires_grad_(True) for t in (q, k, v))
        gl = sdpa_layout(g)
        o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        lms = time_events_ms(
            lambda: torch.autograd.grad(o, (ql, kl, vl), gl, retain_graph=True), 10)
        del o
        # K1 at this shape (its shape in a train step), beside SDPA's forward
        k1_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True), 10)
        with torch.no_grad():
            k1_lib_ms = time_ms(
                lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True), 10)
        log(f"  K1 time at the training shape: kernel {k1_ms:.4f} ms, SDPA is_causal "
            f"{k1_lib_ms:.4f} ms")
        res["flash_attention_fwd_train_shape"] = dict(ms=k1_ms, library_ms=k1_lib_ms)
        pairs = attended_pairs(b, s, s, True)
        rows = 2 * 4 * b * h * s  # lse and delta, fp32
        # bytes: dq reads q, dO, k, v and writes dq; dkv reads the same and
        # writes dk and dv once, in k's type
        dq_b, dq_by = bound_ms(2 * (3 * q.numel() + 2 * k.numel()) + rows, 6 * pairs * d * h)
        dkv_b, dkv_by = bound_ms(2 * (2 * q.numel() + 4 * k.numel()) + rows,
                                 8 * pairs * d * h)
        delta_b, _ = bound_ms(2 * 2 * q.numel() + rows // 2, 2 * q.numel())
        log(f"  K3 time at the training shape: dq {dq_ms:.4f} ms (bound {dq_b:.4f} "
            f"{dq_by}), dkv {dkv_ms:.4f} ms (bound {dkv_b:.4f} {dkv_by}), delta "
            f"{delta_ms:.4f} ms (bound {delta_b:.4f} bytes, plain {delta_plain_ms:.4f}, "
            f"torch.linalg.vecdot on fp32 {delta_lib_ms:.4f}), whole backward {all_ms:.4f} "
            f"ms, plain {pms:.4f} ms, SDPA backward (dq, dk, dv together) {lms:.4f} ms")
        # plain_ms and library_ms are times of the WHOLE backward (all three kernels' work)
        res["flash_attention_bwd_dq"].update(
            ms=dq_ms, plain_ms=pms, library_ms=lms, bound_ms=dq_b, bound_by=dq_by,
            delta_ms=delta_ms, delta_plain_ms=delta_plain_ms, delta_bound_ms=delta_b,
            delta_library_ms=delta_lib_ms, whole_backward_ms=all_ms)
        res["flash_attention_bwd_dkv"].update(
            ms=dkv_ms, plain_ms=pms, library_ms=lms, bound_ms=dkv_b, bound_by=dkv_by)
        del q, k, v, g, out, lse, delta, ql, kl, vl, gl

    # K4: every kernel_cases.POLICY_CASES and POLICY_EDGE_CASES case, twice for
    # equal bits; at the bf16 training shape the error must be that of the
    # output's own rounding (at most twice max |bf16(plain) - plain|)
    name = "flash_policy_attention_fwd"
    for case in kc.POLICY_CASES + kc.POLICY_EDGE_CASES:
        try:
            err, rounding = kc.check_policy_case(case, dev)
        except AssertionError as e:
            raise RuntimeError(str(e)) from e
        tol = FP32_TOL if case.dtype == torch.float32 else BF16_TOL
        log(f"  {kc.describe_policy_case(case)}: max_abs_err={err:.3e} (atol=rtol={tol:g}), "
            "two launches equal: ok")
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        if case.label != "training shape" or case.dtype != torch.bfloat16:
            continue
        log(f"  K4 training shape bf16: max |kernel - plain| {err:.3e}, max |bf16(plain) - "
            f"plain| {rounding:.3e} ({err / rounding:.2f}x, limit 2x)")
        require(err <= 2 * rounding, "K4 training shape: the error is more than twice that of "
                "the output's own bf16 rounding")
        q, k, v, pol = kc.make_policy_inputs(case, dev)
        b, s, h, d = q.shape
        kms = time_ms(lambda: flash_policy_attention(q, k, v, pol), 5)
        pms = time_events_ms(lambda: flash_policy_attention_plain(q, k, v, pol), 3)
        # the wrapper's two kernels apart: the column sum of v, then the main kernel
        split = kernel_ms_by_name(lambda: flash_policy_attention(q, k, v, pol), 5)
        vsum_ms = sum(ms for n, ms in split.items() if "policy_vsum" in n)
        main_ms = sum(ms for n, ms in split.items() if "flash_policy_fwd" in n)
        # beside it, not a yardstick of the same function (no eps terms): SDPA
        # with the causal mask and log(p') as one float mask
        idx = torch.arange(s, device=dev)
        keep = pol[:, None, :].expand(b, s, s).clone()
        keep[:, idx, idx] = 1.0
        mask = keep.log_().masked_fill_(idx[None, :] > idx[:, None], float("-inf"))
        mask = mask[:, None].to(q.dtype)
        del keep
        ql, kl, vl = sdpa_layout(q), sdpa_layout(k), sdpa_layout(v)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask), 5)
        del mask, ql, kl, vl
        pairs = attended_pairs(b, s, s, True)
        bms, bby = bound_ms(2 * (2 * q.numel() + 2 * k.numel()) + 4 * pol.numel(),
                            4 * pairs * d * h + v.numel())
        k1 = res["flash_attention_fwd_train_shape"]["ms"]
        log(f"  K4 time at the training shape: kernel {kms:.4f} ms (column sum {vsum_ms:.4f}, "
            f"main kernel {main_ms:.4f}; {kms / k1:.2f}x K1 at this shape), plain {pms:.4f} "
            f"ms, bound {bms:.4f} ms ({bby})")
        log(f"  SDPA with a causal + log(p') float mask, not the same function (no eps terms): "
            f"{sdpa_ms:.4f} ms")
        res[name].update(ms=kms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=bby,
                         vsum_ms=vsum_ms, main_ms=main_ms, sdpa_log_policy_mask_ms=sdpa_ms,
                         bf16_rounding_err=rounding)
        del q, k, v, pol

    # autograd through K1 + K3 against autograd through the plain forward
    b, s, h, hkv, d = 2, 517, 8, 4, 128
    ins = [randn(b, s, h, d, dtype=torch.float32).requires_grad_(True),
           randn(b, s, hkv, d, dtype=torch.float32).requires_grad_(True),
           randn(b, s, hkv, d, dtype=torch.float32).requires_grad_(True)]
    g = randn(b, s, h, d, dtype=torch.float32)
    got = torch.autograd.grad(fa.flash_attention_vjp(*ins), ins, g)
    want = torch.autograd.grad(fa.flash_attention_plain(*ins), ins, g)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        err = (a - r).abs().max().item()
        ok = torch.allclose(a, r, atol=FP32_TOL, rtol=FP32_TOL)
        log(f"  autograd through K1+K3 vs through the plain forward, {name} "
            f"[B={b} S={s} H={h} Hkv={hkv} d={d} fp32]: max_abs_err={err:.3e} "
            f"(atol=rtol={FP32_TOL:g}) {'ok' if ok else 'FAIL'}")
        require(ok, f"autograd {name}: K1+K3 disagree with the plain forward's gradient")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


def small_config():
    """A small GQA model (head_dim 64) for the card-against-CPU phases."""
    from dynamic_llava_tpu_torch.config import (
        ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig)

    return LlavaConfig(
        text=LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                              num_attention_heads=4, num_key_value_heads=2),
        vision=ClipVisionConfig.tiny(hidden_size=128, intermediate_size=256,
                                     num_attention_heads=2),
        sparse=SparseConfig(d_model=64, nhead=2, dim_feedforward=128, num_layers=1,
                            output_text_len_for_training=8),
    )


def train_batch(cfg, b: int, text_len: int, seed: int = SEED):
    """``(plan, images)``: ``b`` rows of one image and ``text_len - 1`` text
    tokens, the second half of each row supervised."""
    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.constants import IGNORE_INDEX
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch

    rng = np.random.default_rng(seed)
    ids, labels = [], []
    for _ in range(b):
        row = rng.integers(3, cfg.text.vocab_size, size=(text_len,)).astype(np.int64)
        row[2] = IMAGE_TOKEN_INDEX
        lab = row.copy()
        lab[: text_len // 2] = IGNORE_INDEX
        ids.append(row)
        labels.append(lab)
    plan = plan_batch(ids, cfg.num_image_tokens, labels_list=labels)
    size = cfg.vision.image_size
    return plan, rng.standard_normal((b, size, size, 3), dtype=np.float32)


def check_tower_gradient(torch):
    """Phase 3, K1 + K3 under the CLIP tower: the gradient of
    ``encode_images(frozen_tower=False)`` with respect to the tower's
    ``patch_embedding`` on the card (the tower's attention is the autograd
    Function over K1 and K3) against the same gradient on the CPU (plain
    versions), fp32, atol = rtol = 1e-4; under ``no_grad`` the tower launches
    K1 once a layer and K3 never."""
    from dynamic_llava_tpu_torch.models.dynamic import encode_images
    from dynamic_llava_tpu_torch.ops import flash_attention as fa
    from dynamic_llava_tpu_torch.weights import init_llava_params, map_leaves

    cfg = small_config()
    rng = np.random.default_rng(SEED)
    size = cfg.vision.image_size
    pix = torch.from_numpy(rng.standard_normal((2, size, size, 3), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (2, cfg.num_image_tokens, cfg.text.hidden_size), dtype=np.float32))
    cpu = init_llava_params(cfg, torch.Generator().manual_seed(SEED), "cpu", torch.float32)
    grads = {}
    for device in ("cpu", "cuda"):
        params = map_leaves(lambda _, t: t.to(device), cpu)
        leaf = params["vision_tower"]["patch_embedding"].clone().requires_grad_(True)
        params["vision_tower"] = dict(params["vision_tower"], patch_embedding=leaf)
        out = encode_images(params, cfg, pix.to(device), frozen_tower=False)
        grads[device] = torch.autograd.grad((out * g.to(device)).sum(), leaf)[0].cpu()
    err = (grads["cuda"] - grads["cpu"]).abs().max().item()
    top = grads["cpu"].abs().max().item()
    ok = torch.allclose(grads["cuda"], grads["cpu"], atol=FP32_TOL, rtol=FP32_TOL)
    log(f"  CLIP tower gradient w.r.t. patch_embedding, card (K1 + K3) vs CPU: "
        f"max_abs_err={err:.3e}, max |grad| {top:.3e} (atol=rtol={FP32_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok and top > 0, "the tower's gradient on the card disagrees with the CPU's")
    layers = cfg.vision.num_hidden_layers + cfg.vision.select_layer + 1
    before = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches)
    with torch.no_grad():
        encode_images(map_leaves(lambda _, t: t.cuda(), cpu), cfg, pix.cuda())
    rose = (fa.flash_attention.launches - before[0], fa.flash_attention_bwd_dq.launches - before[1])
    require(rose == (layers, 0), f"the tower under no_grad launched K1, K3 {rose} times, not "
            f"({layers}, 0)")


def check_small_train(torch):
    """Phase 4, training: two train steps of the small model on the card
    (kernels K1, K3, K4) against the same two steps on the CPU (plain
    versions), fp32, from the same weights, batch and Gumbel noise. Adam's
    eps is 1e-5 on both sides, so that a gradient that is rounding noise
    around zero does not move its parameter by a whole lr."""
    from dynamic_llava_tpu_torch.train.optimizer import label_params, make_optimizer
    from dynamic_llava_tpu_torch.train.step import batch_from_plan, make_train_step
    from dynamic_llava_tpu_torch.weights import init_llava_params, map_leaves, named_leaves

    cfg = small_config()
    plan, images = train_batch(cfg, 3, 60)
    b, s = plan.token_ids.shape
    gen = torch.Generator().manual_seed(SEED)
    noises = [[torch.rand(shape, generator=gen).clamp_(min=1e-30)
               for shape in ((b, cfg.num_image_tokens, 2), (b, s, 2), (b, s, 2))]
              for _ in range(2)]
    runs = {}
    for device in ("cpu", "cuda"):
        params = init_llava_params(cfg, torch.Generator().manual_seed(SEED), "cpu",
                                   torch.float32)
        params = map_leaves(lambda _, t: t.to(device), params)
        opt = make_optimizer(base_lr=1e-3, predictor_lr=5e-3, weight_decay=0.01, eps=1e-5)
        step = make_train_step(cfg, opt, labels=label_params(params))
        state = opt.init(params)
        batch = batch_from_plan(plan, images, device)
        losses = []
        for noise in noises:
            _, _, metrics = step(params, state, batch, [u.to(device) for u in noise], 0.8)
            losses.append({k: float(v) for k, v in metrics.items()})
        runs[device] = (losses, {p: t.cpu() for p, t in named_leaves(params)})
    for i, (lc, lg) in enumerate(zip(runs["cpu"][0], runs["cuda"][0])):
        log(f"  small train step {i + 1}: card {lg} | CPU {lc}")
        for k in lc:
            require(abs(lg[k] - lc[k]) <= 1e-3 * abs(lc[k]) + 1e-6,
                    f"small train step {i + 1}: {k} card {lg[k]} != CPU {lc[k]} (rtol 1e-3)")
    worst = max(((runs["cuda"][1][p] - t).abs().max().item(), p)
                for p, t in runs["cpu"][1].items())
    log(f"  small train: max parameter difference after 2 steps {worst[0]:.3e} at "
        f"{worst[1]} (atol 1e-4)")
    require(worst[0] <= 1e-4, f"small train: parameters differ by {worst[0]} at {worst[1]}")


def train_launches(cfg) -> dict:
    """K1's, K3's and K4's launches in one train step under remat
    ``nothing`` of ``cfg``'s layer layout, sparse and dense stage: the CLIP
    tower (to layer -2) runs K1 forward only; a decoder layer runs its
    attention forward twice (forward and recompute) and its backward once,
    K1 + K3 below ``sparse_layer`` (every layer in the dense stage), K4 at
    and above it."""
    clip_layers = cfg.vision.num_hidden_layers + cfg.vision.select_layer + 1
    depth, sl = cfg.text.num_hidden_layers, cfg.sparse.sparse_layer
    return {
        "sparse": {"flash_attention_fwd": clip_layers + 2 * sl, "flash_attention_bwd_delta": sl,
                   "flash_attention_bwd_dq": sl, "flash_attention_bwd_dkv": sl,
                   "flash_policy_attention_fwd": 2 * (depth - sl)},
        "dense": {"flash_attention_fwd": clip_layers + 2 * depth,
                  "flash_attention_bwd_delta": depth,
                  "flash_attention_bwd_dq": depth, "flash_attention_bwd_dkv": depth,
                  "flash_policy_attention_fwd": 0},
    }


def train(torch, params, cfg, label, expect, steps=TRAIN_STEPS, remat_policy="nothing"):
    """``steps`` steps of ``Trainer.train`` on ``params`` (updated in
    place) under ``remat_policy`` with the launch counters of K1, K3 and K4
    zeroed before and held against ``expect`` (a step's counts) after.
    Returns the measurements."""
    import tempfile

    from dynamic_llava_tpu_torch.ops import flash_attention as fa
    from dynamic_llava_tpu_torch.ops.flash_policy import flash_policy_attention
    from dynamic_llava_tpu_torch.train.trainer import Trainer, TrainerConfig
    from dynamic_llava_tpu_torch.weights import named_leaves

    counters = {"flash_attention_fwd": fa.flash_attention,
                "flash_attention_bwd_delta": fa.flash_attention_bwd_delta,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "flash_policy_attention_fwd": flash_policy_attention}
    plan, images = train_batch(cfg, TRAIN_BATCH, TRAIN_TEXT_LEN)
    b, s = plan.token_ids.shape
    # leaves that must move. (A norm weight of 1.0 does not, in bf16: the
    # base lr of 5e-6 is far below half an ulp of 1.0.) The predictors get a
    # gradient only while they are on.
    probes = ["llm/layers/q", "llm/embed", "mm_projector/[0]/w"]
    if cfg.sparse.use_output_text_predictor:
        probes.append("predictors/output_text_score_predictor/fc1/w")
    leaves = dict(named_leaves(params))
    before = {p: leaves[p].float().sum().item() for p in probes}
    frozen_before = leaves["vision_tower/class_embedding"].clone()

    with tempfile.TemporaryDirectory() as out_dir:
        # warmup 1 step of 100: the first step runs at lr 0, as in the JAX trainer
        tc = TrainerConfig(output_dir=out_dir, num_train_steps=100, warmup_ratio=0.01,
                           logging_steps=1, save_steps=0, report_to="none", seed=SEED,
                           remat_policy=remat_policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, params, tc)
        for fn in counters.values():
            fn.launches = 0
        times, losses = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.train([(plan, images)])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(metrics)
        got = {n: fn.launches for n, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        del trainer
    want = {n: c * steps for n, c in expect.items()}
    require(got == want, f"{label}: launches {got} != {want} (the layer layout's counts)")
    for i, m in enumerate(losses):
        require(all(np.isfinite(v) for v in m.values()), f"{label} step {i + 1}: {m}")
    after = {p: leaves[p].float().sum().item() for p in probes}
    require(all(after[p] != before[p] for p in probes),
            f"{label}: parameters did not change: {before} -> {after}")
    require(torch.equal(leaves["vision_tower/class_embedding"], frozen_before),
            f"{label}: a frozen leaf changed")
    step_s = sum(times[1:]) / len(times[1:])
    r = dict(first_step_s=times[0], step_ms=step_s * 1e3, tok_s=b * s / step_s,
             peak_gib=peak, depth=cfg.text.num_hidden_layers, launches=got,
             launches_per_step={n: c // steps for n, c in got.items()})
    keys = ("loss", "lm_loss", "image_mask_loss", "output_text_mask_loss", "grad_norm")
    log(f"  {label}: depth {r['depth']}, B={b}, S={s}; first step {times[0]:.3f} s, then "
        f"{r['step_ms']:.1f} ms/step ({r['tok_s']:.1f} tok/s), peak {peak:.2f} GiB; "
        f"launches {got}; "
        + "; ".join(f"step {i + 1} " + " ".join(f"{k}={m[k]:.4f}" for k in keys if k in m)
                    for i, m in enumerate(losses)))
    return r


def check_small_model(torch):
    """Phase 4: greedy generation of a small GQA model (head_dim 64) on the
    card (kernels, fp32) must match the port's plain CPU path token for
    token, with plain, int8 and int4 decoder weights; then the lean modes
    (int8 and fp8 KV caches, ring overflow past both tiers' wrap, int4
    weights with the fused MLP, and that with an int8 cache). In a lean
    mode a stored byte or a bf16 ``h`` may round the other way on the card
    (its fp32 sums run in another order), so there the logits of every step
    are held under teacher forcing with the CPU's tokens (atol 5e-2; ring
    with its fp32 cache 1e-3 and token for token), and whether the free
    runs agree token for token is logged."""
    import os

    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.generation.generate import (
        GenerationConfig, Generator)
    from dynamic_llava_tpu_torch.models.dynamic import decode_step
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
    from dynamic_llava_tpu_torch.ops.quant import quantize_llm_params
    from dynamic_llava_tpu_torch.weights import init_llava_params, map_leaves

    cfg = small_config()
    rng = np.random.default_rng(SEED)
    ids = [np.concatenate([rng.integers(3, 500, 7), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, 500, 9 + i)]) for i in range(3)]
    pix = rng.standard_normal((3, 56, 56, 3), dtype=np.float32)
    base = dict(max_new_tokens=16, cache_dtype="float32", pad_multiple=8, decode_chunk=8,
                eos_token_id=-1)

    def make(bits):
        cpu_params = init_llava_params(cfg, torch.Generator().manual_seed(SEED), "cpu",
                                       torch.float32)
        if bits:
            quantize_llm_params(cpu_params, bits=bits)
        return cpu_params, map_leaves(lambda _, t: t.cuda(), cpu_params)

    for bits in (None, 8, 4):
        cpu_params, gpu_params = make(bits)
        gc = GenerationConfig(**base)
        want = Generator(cpu_params, cfg, gc).generate(ids, pix)
        got = Generator(gpu_params, cfg, gc).generate(ids, pix)
        kind = f"int{bits}" if bits else "fp32"
        log(f"  small model ({kind} weights) tokens (card): {got}")
        require(got == want,
                f"small model {kind}: card tokens {got} != plain CPU {want}")
        log(f"  small model ({kind} weights): card == plain CPU path, token for token")

    def forced_logits(gen, gc, tokens):
        """Prefill and one decode step per token of ``tokens`` (teacher
        forcing): the logits of every step, on the host."""
        plan = plan_batch(ids, cfg.num_image_tokens, pad_multiple=gc.pad_multiple)
        steps = len(tokens[0])
        with torch.inference_mode():
            state, _ = gen.prefill_from_plan(plan, pix, steps)
            logits = [state.last_logits]
            for i in range(steps):
                tok = torch.tensor([o[i] for o in tokens], device=gen.device)
                state = decode_step(gen.params, cfg, tok, state, kv_overflow=gc.kv_overflow)
                logits.append(state.last_logits)
        return torch.stack(logits).float().cpu()

    lean = [
        ("int8 KV", None, dict(cache_dtype="int8"), False, 5e-2),
        ("fp8 KV", None, dict(cache_dtype="float8_e4m3fn"), False, 5e-2),
        ("ring overflow", None, dict(kv_overflow="ring", kv_window=2, max_new_tokens=40),
         False, 1e-3),
        ("int4 weights, fused MLP", 4, {}, True, 5e-2),
        ("int4 weights, fused MLP, int8 KV", 4, dict(cache_dtype="int8"), True, 5e-2),
    ]
    for label, bits, over, fused, tol in lean:
        cpu_params, gpu_params = make(bits)
        gc = GenerationConfig(**dict(base, **over))
        os.environ.pop(Q4_MLP_SWITCH, None)
        if fused:
            os.environ[Q4_MLP_SWITCH] = "1"
        try:
            cpu_gen, gpu_gen = Generator(cpu_params, cfg, gc), Generator(gpu_params, cfg, gc)
            want = cpu_gen.generate(ids, pix)
            got = gpu_gen.generate(ids, pix)
            ref, out = forced_logits(cpu_gen, gc, want), forced_logits(gpu_gen, gc, want)
        finally:
            os.environ.pop(Q4_MLP_SWITCH, None)
        err = (out - ref).abs().max().item()
        same = got == want
        log(f"  small model ({label}): logits of {out.shape[0]} steps card vs plain CPU "
            f"path max_abs_err={err:.3e} (atol {tol:g}); free-running tokens "
            f"{'equal' if same else 'differ'}: {got}")
        require(bool(torch.isfinite(out).all()) and err <= tol,
                f"small model {label}: logits differ by {err} (atol {tol})")
        require(same or tol > 1e-3, f"small model {label}: card tokens {got} != CPU {want}")


Q4_MLP_SWITCH = "DYNAMIC_LLAVA_Q4_MLP"


def cache_bytes(cache) -> int:
    """Bytes of a tiered KV cache: K, V and the int8 mode's scales."""
    return sum(t.numel() * t.element_size()
               for tier in (cache.pre, cache.post)
               for t in (tier.k, tier.v, tier.k_scale, tier.v_scale) if t is not None)


def eager_decode(torch, gen, plan, pix, steps):
    """The graph's reference: prefill, then ``steps`` greedy decode steps as
    an eager loop of ``argmax`` + ``decode_step`` on the card, one launch at
    a time. Returns (``[steps, B]`` tokens, step wall ms, the serving
    kernels' wrapper calls of the prefill and the steps by
    ``kernel_cases.SERVING_KERNELS`` label)."""
    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.models.dynamic import decode_step

    before = kc.read_counters()
    with torch.inference_mode():
        state, _ = gen.prefill_from_plan(plan, pix, steps)
        toks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = torch.argmax(state.last_logits, dim=-1)
            state = decode_step(gen.params, gen.cfg, tok, state,
                                kv_overflow=gen.gen_cfg.kv_overflow)
            toks.append(tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
    calls = kc.wrapper_calls(before, kc.read_counters())
    return torch.stack(toks).cpu().numpy(), step_ms, calls


def graph_decode(torch, gen, plan, pix, steps):
    """The graph side, timed as ``eager_decode`` times the eager loop:
    prefill into the ``Generator``'s runner, then the host clock around its
    chunks (replays of the captured step; chunk k+1 enqueued before chunk
    k's tokens are read, as ``generate`` does) up to the last chunk's
    tokens. Returns (``[steps, B]`` tokens, step wall ms)."""
    with torch.inference_mode():
        state, _ = gen.prefill_from_plan(plan, pix, steps)
        runner = gen.runner(plan, pix, steps)
        runner.load(state, 0)
        del state
        n = steps // runner.chunk
        toks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = runner.run_chunk()
        for ci in range(n):
            following = runner.run_chunk() if ci + 1 < n else None
            toks.append(pending.tokens())
            pending = following
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
    return np.concatenate(toks), step_ms


def serving_batch(cfg, b: int, n_text: int):
    """The serving phases' batch, made from ``SEED``: ``b`` prompts of
    ``n_text`` random text tokens around one image token, and ``b``
    preprocessed images of random pixels."""
    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(SEED)
    vocab, size = cfg.text.vocab_size, cfg.vision.image_size
    ids = [np.concatenate([rng.integers(3, vocab, n_text // 2), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, vocab, n_text - n_text // 2)])
           for _ in range(b)]
    return ids, rng.standard_normal((b, size, size, 3), dtype=np.float32)


def serve(torch, params, modes, counters, need, label, b=8, max_new=64, n_text=60,
          batches=2):
    """For each mode of ``modes`` on the same weights, the main path:
    ``batches`` batches of ``b`` requests (one image and ``n_text`` text
    tokens each, the same prompts for every call) through
    ``Generator.generate``, with every wrapper's count in ``counters``
    (name -> wrapper) zeroed just before and read just after, and the
    serving kernels' launches on the card counted in a profiler trace of
    those calls (``kernel_cases.device_launches``). A mode is ``(name,
    cfg)`` or ``(name, cfg, opts)``: ``opts["gen"]`` are
    ``GenerationConfig`` fields (``cache_dtype``, ``kv_overflow``,
    ``kv_window``), ``opts["fused"]`` switches the fused int4 MLP (K9) on
    for the mode. Every wrapper named in ``need`` must be called in each
    mode (K9 only with the switch on); on the card K2 must launch once per
    layer and decode step, K9 as often with the switch on and never with it
    off, and every serving kernel as often as the wrappers of an eager loop
    (``eager_decode``) launch it for the same prefill and steps. Then, apart
    from the counts and the trace: ``TIMED`` more ``generate`` calls timed, the prefill
    timed alone (TTFT), the graph's and the eager loop's step walls, and the
    graph's tokens held against the eager loop's. Returns the per-mode
    measurements."""
    import os

    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.models.dynamic import gen_cache_sizes
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch

    cfg0 = modes[0][1]
    vocab = cfg0.text.vocab_size
    ids, pix = serving_batch(cfg0, b, n_text)
    results = {}
    for mode, cfg, *rest in modes:
        opts = rest[0] if rest else {}
        fused = bool(opts.get("fused"))
        # eos -1: every request runs to max_new, so each run does the same work
        gc = GenerationConfig(max_new_tokens=max_new, temperature=0.0, eos_token_id=-1,
                              **opts.get("gen", {}))
        plan = plan_batch(ids, cfg0.num_image_tokens, pad_multiple=gc.pad_multiple)
        chunk = max(1, min(gc.decode_chunk, max_new))
        steps = -(-max_new // chunk) * chunk  # decode steps of one generate call
        gen = Generator(params, cfg, gc)
        sizes = gen_cache_sizes(cfg, plan.seq_len, steps, bucket=gc.pad_multiple,
                                decode_window=gc.kv_window, ring=gc.kv_overflow == "ring")
        os.environ.pop(Q4_MLP_SWITCH, None)
        if fused:
            os.environ[Q4_MLP_SWITCH] = "1"
        try:
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # the main path (the first call captures the decode step); one
            # trace a call keeps the profiler's buffers small
            outs, per_call = [], []
            t_stage = time.perf_counter()
            for _ in range(batches):
                out, seen = kc.device_launches(lambda: gen.generate(ids, pix))
                outs.append(out)
                per_call.append(seen)
            device = {k: sum(c[k] for c in per_call) for k in kc.SERVING_KERNELS}
            calls = {name: fn.launches for name, fn in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            runner = gen.decode_runner
            stage_s = {"traced": time.perf_counter() - t_stage}
            t_stage = time.perf_counter()
            # timed apart from the trace: TIMED calls and as many prefills
            # alone, the median of each kept (the host's pace varies)
            e2es, ttfts = [], []
            for _ in range(TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(gen.generate(ids, pix))
                torch.cuda.synchronize()
                e2es.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                with torch.inference_mode():
                    state, info = gen.prefill_from_plan(plan, pix, steps)
                torch.cuda.synchronize()
                ttfts.append(time.perf_counter() - t0)
            e2e, ttft = statistics.median(e2es), statistics.median(ttfts)
            require(bool(torch.isfinite(state.last_logits).all()),
                    f"{label} {mode}: non-finite prefill logits")
            kv_gib, kv_dtype = cache_bytes(state.cache) / 2**30, state.cache.pre.k.dtype
            tiers = (state.cache.pre.max_len, state.cache.post.max_len)
            del state
            # the graph's tokens and step wall against the eager loop's, all steps
            require(gen.decode_runner is runner and runner.graph is not None,
                    f"{label} {mode}: decode took no CUDA graph, or not one graph")
            stage_s["timed"] = time.perf_counter() - t_stage
            t_stage = time.perf_counter()
            graph_toks, graph_ms = graph_decode(torch, gen, plan, pix, steps)
            stage_s["graph"] = time.perf_counter() - t_stage
            t_stage = time.perf_counter()
            eager_toks, eager_ms, eager_calls = eager_decode(torch, gen, plan, pix, steps)
            stage_s["eager"] = time.perf_counter() - t_stage
        finally:
            os.environ.pop(Q4_MLP_SWITCH, None)
        for name in need:
            wanted = fused or name != "q4_mlp"
            require((calls[name] > 0) == wanted,
                    f"{label} {mode}: {name}'s wrapper called {calls[name]} times ({calls})")
        per_layer = batches * steps * cfg.text.num_hidden_layers
        require(device["decode_kernel"] == per_layer,
                f"{label} {mode}: K2 launched {device['decode_kernel']} times on the card, "
                f"not {per_layer} (by call {per_call}; eager loop {eager_calls})")
        require(device["q4_mlp_kernel"] == (per_layer if fused else 0),
                f"{label} {mode}: K9 launched {device['q4_mlp_kernel']} times on the card "
                f"with the switch {'on' if fused else 'off'} (by call {per_call})")
        require(all(c == eager_calls for c in per_call),
                f"{label} {mode}: launches on the card by call {per_call} != the eager "
                f"loop's wrapper calls {eager_calls}")
        out = outs[-1]
        require(all(o == out for o in outs),
                f"{label} {mode}: batches of the same prompts differ")
        require(len(out) == b and all(len(o) == max_new for o in out),
                f"{label} {mode}: wrong output lengths")
        require(all(0 <= t < vocab for o in out for t in o),
                f"{label} {mode}: token id out of range")
        new_len = info.new_length.tolist()
        want_len = [int(v) - (cfg.num_image_tokens - cfg.vision_keep_budget)
                    for v in plan.valid_len]
        require(new_len == want_len,
                f"{label} {mode}: new_length {new_len} != {want_len}")
        require(tiers == sizes, f"{label} {mode}: tier capacities")
        tok_s = b * max_new / (e2e - ttft)
        same = bool(np.array_equal(np.asarray(out).T, eager_toks[:max_new])
                    and np.array_equal(graph_toks, eager_toks))
        graph = dict(eager_step_ms=eager_ms, graph_step_ms=graph_ms,
                     capture_ms=runner.capture_ms, tokens_equal=same)
        require(same, f"{label} {mode}: graph tokens differ from the eager loop's")
        results[mode] = dict(e2e_s=e2e, ttft_ms=ttft * 1e3, decode_tok_s=tok_s,
                             peak_gib=peak, kv_gib=kv_gib, pre=sizes[0], post=sizes[1],
                             launches=calls, device_launches=device, graph=graph, tokens=out)
        log(f"  {label} {mode}: B={b}, prompt length {plan.seq_len}, {max_new} new tokens, "
            f"tier capacities pre={sizes[0]} post={sizes[1]}, KV cache "
            f"{kv_dtype} {kv_gib:.3f} GiB; generate {e2e:.3f} s, TTFT "
            f"{ttft * 1e3:.1f} ms, decode {tok_s:.1f} tok/s, peak {peak:.2f} GiB, "
            f"new_length {new_len[:2]}... (prompt {plan.valid_len.tolist()[:2]}...), "
            f"wrapper calls {calls}, launches on the card {device}, "
            f"first tokens {out[0][:8]}")
        log(f"  {label} {mode}: decode step wall {eager_ms:.3f} ms eager, "
            f"{graph_ms:.3f} ms graph (capture {runner.capture_ms:.1f} ms); "
            "graph tokens == eager loop's; seconds "
            + ", ".join(f"{k} {v:.1f}" for k, v in stage_s.items()))
        del gen, runner, info
    return results


class Keywords:
    """A stopping criteria shaped like LLaVA's ``KeywordsStoppingCriteria``:
    token sequences (``keyword_ids``, matched on the device by the chat's
    stopping runner), and the same test on the host for the per-token path."""

    def __init__(self, *seqs):
        self.keyword_ids = [list(map(int, seq)) for seq in seqs]

    def __call__(self, out):
        return any(out[-len(seq):] == seq for seq in self.keyword_ids)


def chat(torch, params, modes):
    """Phase 5b: multi-round chat at 7B width through ``ChatSession.ask``,
    for each mode of ``modes`` (``(name, cfg, GenerationConfig fields)``) on
    the same weights. Round 1 is one 336x336 image and 60 text tokens,
    rounds 2 and 3 chunks of ``CHAT_CHUNKS`` tokens through the
    continuation prefill; each round runs to ``CHAT_MAX_NEW`` new tokens
    under a two-token keyword stop, EOS off (so every round does the same
    work). The main path, one session's three rounds, runs with the
    wrappers' counters zeroed just before and read just after, inside a
    profiler trace that counts the launches on the card: the M-query
    kernel once a layer in each continued round, K2 once a layer in every
    decode step the session's runner ran (its chunks, the frozen one
    enqueued past the stop included). A second session driven by
    ``_ask_tokenwise`` (eager, one host read a token) must give the same
    tokens, tier lengths and ``next_pos`` after every round. A third,
    untraced session through ``ask`` is timed with each round's prefill or
    continuation timed apart (host clock after ``synchronize``): round-1
    TTFT, the continuation's ms a chunk, and decode tok/s at B=1 over
    rounds 2 and 3 (round 1's decode includes the step's capture)."""
    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.generation.generate import (
        ChatSession, GenerationConfig, Generator)
    from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention, extend_attention

    cfg0 = modes[0][1]
    rng = np.random.default_rng(SEED + 5)
    vocab, size = cfg0.text.vocab_size, cfg0.vision.image_size
    prompt = np.concatenate([rng.integers(3, vocab, 30), [IMAGE_TOKEN_INDEX],
                             rng.integers(3, vocab, 30)])
    pix = rng.standard_normal((1, size, size, 3), dtype=np.float32)
    rounds = [(prompt, pix)] + [(rng.integers(3, vocab, n), None) for n in CHAT_CHUNKS]
    stop = Keywords(rng.integers(3, vocab, 2))
    wrappers = {"extend_kernel": extend_attention, "decode_kernel": decode_attention}

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def after_round(session):
        return session.cache_lengths()[:, 0].tolist(), int(session.state.next_pos[0])

    results = {}
    for mode, cfg, opts in modes:
        # EOS is a token id the model cannot emit
        gc = GenerationConfig(max_new_tokens=CHAT_MAX_NEW, temperature=0.0, eos_token_id=vocab,
                              **opts)
        gen = Generator(params, cfg, gc)
        layers = cfg.text.num_hidden_layers
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # the main path: three rounds through ChatSession.ask, one trace a
        # round
        session = ChatSession(gen, CHAT_BUDGET)
        for fn in wrappers.values():
            fn.launches = 0
        t_main = time.perf_counter()
        outs, states, device = [], [], dict.fromkeys(kc.SERVING_KERNELS, 0)
        for ids, px in rounds:
            out, seen = kc.device_launches(
                lambda: session.ask(ids, px, stopping_criteria=stop))
            outs.append(out)
            states.append(after_round(session))
            device = {k: device[k] + seen[k] for k in device}
        t_main = time.perf_counter() - t_main
        calls = {name: fn.launches for name, fn in wrappers.items()}
        runner = session.runner
        steps = runner.chunks_run * runner.chunk
        require(device["extend_kernel"] == (len(rounds) - 1) * layers,
                f"chat {mode}: the M-query kernel launched {device['extend_kernel']} times on "
                f"the card, not once a layer in each of {len(rounds) - 1} continued rounds")
        require(device["decode_kernel"] == steps * layers,
                f"chat {mode}: K2 launched {device['decode_kernel']} times on the card, not "
                f"once a layer in each of the runner's {steps} steps")
        require(all(len(o) == CHAT_MAX_NEW for o in outs)
                and all(0 <= t < vocab for o in outs for t in o),
                f"chat {mode}: answers of {[len(o) for o in outs]} tokens")

        # the reference: the per-token path, eager, on a session of its own
        t_ref = time.perf_counter()
        ref = ChatSession(gen, CHAT_BUDGET)
        ref_outs, ref_states = [], []
        for ids, px in rounds:
            ref._start_round(ids, px)
            ref_outs.append(ref._ask_tokenwise(stop, CHAT_MAX_NEW))
            ref_states.append(after_round(ref))
        require(outs == ref_outs and states == ref_states,
                f"chat {mode}: ask gave {[o[:6] for o in outs]} with lengths / next_pos "
                f"{states}, the per-token path {[o[:6] for o in ref_outs]} with {ref_states}")
        del ref
        t_ref = time.perf_counter() - t_ref

        # timed: a third session, its prefill / continuation timed apart
        timed = ChatSession(gen, CHAT_BUDGET)
        starts = []
        start_round = timed._start_round

        def timed_start(ids, px, **kw):
            _, sec = sync_time(lambda: start_round(ids, px, **kw))
            starts.append(sec)

        timed._start_round = timed_start
        walls = []
        for (ids, px), want in zip(rounds, outs):
            out, sec = sync_time(lambda: timed.ask(ids, px, stopping_criteria=stop))
            require(out == want, f"chat {mode}: a second session's answer differs")
            walls.append(sec)
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(runner.graph is not None and timed.runner.graph is not None,
                f"chat {mode}: the stopping runner took no CUDA graph")
        capture = float(timed.runner.capture_ms or 0.0)
        decode_s = [w - st for w, st in zip(walls, starts)]
        tok_s = sum(len(o) for o in outs[1:]) / sum(decode_s[1:])
        results[mode] = dict(
            ttft_ms=starts[0] * 1e3, continue_ms=[st * 1e3 for st in starts[1:]],
            chunks=list(CHAT_CHUNKS), decode_tok_s=tok_s,
            round_decode_tok_s=[len(o) / d for o, d in zip(outs, decode_s)],
            capture_ms=capture, peak_gib=peak, tiers=(
                runner.state.cache.pre.max_len, runner.state.cache.post.max_len),
            lengths=states, device_launches=device, launches=calls, steps=steps)
        log(f"  chat {mode}: tiers pre={results[mode]['tiers'][0]} "
            f"post={results[mode]['tiers'][1]}; round-1 TTFT {starts[0] * 1e3:.1f} ms, "
            f"continuation {', '.join(f'{n} tokens {st * 1e3:.1f} ms' for n, st in zip(CHAT_CHUNKS, starts[1:]))}, "
            f"decode {tok_s:.1f} tok/s at B=1 (rounds 2-3; by round "
            f"{', '.join(f'{r:.1f}' for r in results[mode]['round_decode_tok_s'])}, round 1 "
            f"with a {capture:.1f} ms capture), peak {peak:.2f} GiB; lengths / "
            f"next_pos after each round {[(st[0][0], st[0][-1], st[1]) for st in states]}; "
            f"launches on the card {device['extend_kernel']} M-query, {device['decode_kernel']} "
            f"K2 ({steps} steps), wrapper calls {calls}; ask == the per-token path: ok "
            f"(seconds: traced session {t_main:.1f}, per-token session {t_ref:.1f})")
        del session, timed, gen, runner
    return results


BF16_U = 2.0**-8  # bf16 unit roundoff


def near_tie_bound(scale: float, roundings: int) -> float:
    """How close two values computed by the plain and the speculative path
    must be for their order to flip by rounding alone. Both paths compute
    the same function and round it to bf16 at the same points (each of a
    decoder layer's two residual adds, the norms, a predictor layer), but
    over B rows against B x M rows the GEMMs and K2 / K2-M sum in other
    orders, so a rounding may land on the other side: a relative difference
    of up to ``u = 2^-8`` at each of ``roundings`` points. Taken as a random
    walk, two values of magnitude ``scale`` differ by up to ``u *
    sqrt(roundings) * scale``, and a pair closer than that may swap."""
    return BF16_U * roundings**0.5 * scale


class KeepMargins:
    """Records the output-text predictor's keep margins (keep logit minus
    drop logit, and the larger magnitude of the two) of every token the
    decode paths score, by patching ``models.dynamic.text_predictor`` while
    it is entered."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from dynamic_llava_tpu_torch.models import dynamic

        self.module, self.real = dynamic, dynamic.text_predictor

        def recording(p, x):
            tp = self.real(p, x)
            tp32 = tp.float()
            self.calls.append((tp32[..., 0] - tp32[..., 1], tp32.abs().amax(dim=-1)))
            return tp

        dynamic.text_predictor = recording
        return self

    def __exit__(self, *exc):
        self.module.text_predictor = self.real


def eager_speculative(torch, gen, plan, pix, m, max_new, rounds, margins=None):
    """The graph runner's reference: prefill, then at most ``rounds`` rounds
    of host prompt-lookup drafts (``prompt_lookup_draft``, the host form of
    the graph's ``device_prompt_lookup``) + ``decode_speculative_step`` as
    an eager loop on the card, one host read a round, the emission rules of
    ``generate_speculative``. ``margins``: a ``KeepMargins`` entered around
    the rounds, whose records become per-sample ``[(position, margin,
    scale)]`` of the emitted tokens. Returns (tokens a sample, the tiers'
    lengths ``[L, B]``, ``next_pos``, rounds run, the serving kernels'
    wrapper calls of the rounds and of the prefill, the margins)."""
    import contextlib

    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.generation.speculative import prompt_lookup_draft
    from dynamic_llava_tpu_torch.models.dynamic import decode_speculative_step

    dev = gen.device
    b = plan.batch
    eos = gen.gen_cfg.eos_token_id
    prompts = [[int(t) for t in plan.token_ids[i][: plan.valid_len[i]]] for i in range(b)]
    out = [[] for _ in range(b)]
    kept = [[] for _ in range(b)]
    done = np.zeros(b, bool)
    n = 0
    with torch.inference_mode():
        before = kc.read_counters()
        state, _ = gen.prefill_from_plan(plan, pix, max_new + m)
        prefill_calls = kc.wrapper_calls(before, kc.read_counters())
        before = kc.read_counters()
        while not done.all() and n < rounds:
            tn = torch.argmax(state.last_logits, dim=-1).cpu().numpy()
            toks = np.zeros((b, m), np.int64)
            toks[:, 0] = tn
            for i in range(b):
                if not done[i]:
                    d = prompt_lookup_draft(prompts[i] + out[i] + [int(tn[i])], m - 1)[: m - 1]
                    toks[i, 1:1 + len(d)] = d
            seen = len(margins.calls) if margins is not None else 0
            with margins if margins is not None else contextlib.nullcontext():
                state, n_acc, _ = decode_speculative_step(
                    gen.params, gen.cfg, torch.from_numpy(toks).to(dev), state, eos,
                    active=torch.from_numpy(~done).to(dev))
            n_acc = n_acc.cpu().numpy()
            n += 1
            new = margins.calls[seen:] if margins is not None else []
            for i in range(b):
                if done[i]:
                    continue
                take = min(int(n_acc[i]), max_new - len(out[i]))
                for j in range(take):
                    if new:
                        kept[i].append((len(out[i]) + j, float(new[0][0][i, j]),
                                        float(new[0][1][i, j])))
                out[i].extend(int(t) for t in toks[i, :take])
                if eos in toks[i, :take] or len(out[i]) >= max_new:
                    done[i] = True
        calls = kc.wrapper_calls(before, kc.read_counters())
        lengths = torch.cat([state.cache.pre.length, state.cache.post.length]).cpu().numpy()
        next_pos = state.next_pos.cpu().numpy()
    return out, lengths, next_pos, n, calls, prefill_calls, kept


def runner_state(torch, runner):
    """``(tiers' lengths [L, B], next_pos)`` of a runner's state."""
    st = runner.state
    return (torch.cat([st.cache.pre.length, st.cache.post.length]).cpu().numpy(),
            st.next_pos.cpu().numpy().copy())  # a copy on the CPU too: the buffer moves on


def graph_rounds(torch, gen, plan, pix, m, max_new, rounds):
    """The first ``rounds`` rounds of ``generate_speculative_device`` (its
    runner and key: in-graph prompt lookup, ``ROUNDS_PER_CHUNK`` rounds a chunk;
    the first call of a key runs a round eagerly and captures it), driven
    chunk by chunk. Returns (tokens a sample, lengths ``[L, B]``,
    ``next_pos``) after them."""
    from dynamic_llava_tpu_torch.generation.speculative import ROUNDS_PER_CHUNK

    with torch.inference_mode():
        runner = gen.spec_runner(plan, pix, max_new, m, draft=(3, 1), rounds=ROUNDS_PER_CHUNK)
        state, _ = gen.prefill_into(plan, pix, runner.fresh_cache())
        runner.load(state, 0)
        runner.begin(plan, max_new)
        del state
        for _ in range(rounds // ROUNDS_PER_CHUNK):
            runner.run_chunk()
        grid, n_out, _ = runner.results()
    return [[int(t) for t in grid[i, : n_out[i]]] for i in range(plan.batch)], \
        *runner_state(torch, runner)


def plain_near_ties(torch, gen, plan, pix, tokens, steps):
    """The plain path's near ties along its own greedy tokens: an eager loop
    of ``decode_step`` over ``tokens`` (the graph's, which the eager loop
    reproduces bit for bit), recording before each token the top-two logit
    gap and the top logit, and each token's keep margin. Returns ``(gap
    [steps, B], top [steps, B], margins: a step's (margin [B], scale [B]) or
    None)``."""
    from dynamic_llava_tpu_torch.models.dynamic import decode_step

    gaps, tops, margins = [], [], []
    with torch.inference_mode(), KeepMargins() as rec:
        state, _ = gen.prefill_from_plan(plan, pix, steps)
        for j in range(steps):
            top2 = torch.topk(state.last_logits.float(), 2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
            tops.append(top2[:, 0].abs().cpu().numpy())
            tok = torch.from_numpy(np.asarray([t[j] for t in tokens])).to(gen.device)
            n = len(rec.calls)
            state = decode_step(gen.params, gen.cfg, tok, state)
            margins.append(next(((a.cpu().numpy(), s.cpu().numpy())
                                 for a, s in rec.calls[n:]), None))
    return np.stack(gaps), np.stack(tops), margins


def first_divergence(ref, spec):
    """Per sample, the first position where ``spec`` leaves ``ref``, or
    None."""
    return [next((p for p, (x, y) in enumerate(zip(r, s)) if x != y), None)
            for r, s in zip(ref, spec)]


def explain_divergence(cfg, firsts, plain, spec_margins):
    """For each sample whose speculative tokens leave plain greedy's at
    ``firsts[i]`` = j, whether that stands: plain greedy's top-two logit gap
    at j below ``near_tie_bound`` of its top logit (roundings: two a layer
    and the final norm), or the keep margin of a token before j below the
    bound of its magnitude (roundings: two a layer below the sparse layer
    and the predictor's four), on the plain path (``plain``, from
    ``plain_near_ties``) or the speculative one (``spec_margins``, the
    eager loop's). Returns ``{sample: dict(j, gap, gap_bound, margin,
    margin_bound, stands)}``."""
    gaps, tops, plain_margins = plain
    layers, sl = cfg.text.num_hidden_layers, cfg.sparse.sparse_layer
    found = {}
    for i, j in enumerate(firsts):
        if j is None:
            continue
        gap, gap_bound = float(gaps[j, i]), near_tie_bound(float(tops[j, i]), 2 * layers + 1)
        close = []  # (|margin|, bound) of the tokens before j, both paths
        for p in range(j):
            if plain_margins[p] is not None:
                a, sc = plain_margins[p]
                close.append((abs(float(a[i])), near_tie_bound(float(sc[i]), 2 * sl + 4)))
        close += [(abs(a), near_tie_bound(sc, 2 * sl + 4))
                  for p, a, sc in spec_margins[i] if p < j]
        tightest = min(close, key=lambda c: c[0] - c[1], default=(None, None))
        found[i] = dict(j=j, gap=gap, gap_bound=gap_bound, margin=tightest[0],
                        margin_bound=tightest[1],
                        stands=gap < gap_bound or any(a < bd for a, bd in close))
    return found


def speculate(torch, params, arms, label, gemv_kernel=None):
    """Phase 5c: speculative decoding at 7B width for each arm ``(name,
    cfg, B)`` on the same weights, ``SPEC_MAX_NEW`` new tokens, greedy,
    EOS off; each arm at every ``SPEC_KS`` draft length k (M = k + 1).
    Timed (tok/s = B * new tokens / (call wall - TTFT), each on a call
    after the one that captured its key): plain ``generate``;
    ``generate_speculative`` with an oracle draft, plain greedy's own
    continuation, and with a self oracle, the device run's chain (plain
    greedy's chain leaves the speculative one at near ties, and the
    speculative chain moves at near ties with where the rounds cut it, so
    neither is all accepted), and with prompt lookup;
    ``generate_speculative_device`` (``ROUNDS_PER_CHUNK`` rounds a chunk); and,
    computed, the tok/s of every draft accepted: TTFT plus ``ceil(new /
    M)`` verify rounds at their measured device ms.
    Checks: the device-drafted graph runner's tokens, tier lengths and
    ``next_pos`` after its first ``SPEC_EAGER_ROUNDS`` rounds equal an
    eager loop of ``decode_speculative_step`` with the same drafts
    (``eager_speculative``), and after a whole generation the host-drafted
    runner's (prompt lookup on the host); in a profiler trace of the self
    oracle's first generation at the largest k (the wrappers' counters
    zeroed just before and read just after) K2-M launches once a layer a
    round, K2 never, and ``gemv_kernel`` (quantized
    weights) as often as the eager loop's wrappers call it a round, ``4 x
    layers + 1`` (q/k/v, o, gate/up, down, the lm_head), plus the
    prefill's; the speculative tokens equal plain greedy's, or leave them
    only at a near tie (``explain_divergence``). Times: the verify round's
    and the plain decode step's device ms (CUDA events over 10 replays of
    each graph on a fresh prefill) and each key's capture ms."""
    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.generation.speculative import ROUNDS_PER_CHUNK
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def replay_ms(runner, reps=10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            runner.graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    results = {}
    new = SPEC_MAX_NEW
    for name, cfg, b in arms:
        t_arm = time.perf_counter()
        rng = np.random.default_rng(SEED + 7)
        vocab, size = cfg.text.vocab_size, cfg.vision.image_size
        ids = [np.concatenate([rng.integers(3, vocab, 30), [IMAGE_TOKEN_INDEX],
                               rng.integers(3, vocab, 30)]) for _ in range(b)]
        pix = rng.standard_normal((b, size, size, 3), dtype=np.float32)
        gc = GenerationConfig(max_new_tokens=new, temperature=0.0, eos_token_id=-1)
        gen = Generator(params, cfg, gc)
        ref_gen = Generator(params, cfg, gc)  # the eager loops' own buffers
        plan = plan_batch(ids, cfg.num_image_tokens, pad_multiple=gc.pad_multiple)
        layers = cfg.text.num_hidden_layers
        r = dict(batch=b, new_tokens=new, rounds_per_chunk=ROUNDS_PER_CHUNK, k={})

        # plain greedy: its tokens, tok/s, step ms
        gen.generate(ids, pix)
        ref, wall = sync_time(lambda: gen.generate(ids, pix))
        with torch.inference_mode():
            ttft = statistics.median(
                sync_time(lambda: gen.prefill_from_plan(plan, pix, new))[1] for _ in range(3))
            runner = gen.decode_runner
            state, _ = gen.prefill_from_plan(plan, pix, new)
            runner.load(state, 0)
            del state
            r.update(ttft_ms=ttft * 1e3, plain_tok_s=b * new / (wall - ttft),
                     plain_step_ms=replay_ms(runner), plain_capture_ms=runner.capture_ms)
        require(all(len(o) == new for o in ref), f"spec {name}: plain lengths")
        prompt_len = int(plan.valid_len[0])
        prompts = [tuple(int(t) for t in plan.token_ids[i][:prompt_len]) for i in range(b)]

        def oracle_of(chains):
            conts = dict(zip(prompts, chains))

            def oracle(ctx, n):
                cont = conts[tuple(ctx[:prompt_len])]
                return cont[len(ctx) - prompt_len: len(ctx) - prompt_len + n]
            return oracle

        spec_out, spec_margins = {}, {}
        for k in SPEC_KS:
            m = k + 1
            kr = {}
            t_k = time.perf_counter()
            # the graph runner's first rounds against the eager loop's; the
            # first call of the device-drafted key captures it
            margins = KeepMargins() if cfg.sparse.use_output_text_predictor else None
            e_out, e_len, e_pos, e_rounds, e_calls, e_prefill, spec_margins[k] = \
                eager_speculative(torch, ref_gen, plan, pix, m, new, SPEC_EAGER_ROUNDS, margins)
            g_out, g_len, g_pos = graph_rounds(torch, gen, plan, pix, m, new, e_rounds)
            require(g_out == e_out and np.array_equal(g_len, e_len)
                    and np.array_equal(g_pos, e_pos),
                    f"spec {name} k={k}: after {e_rounds} rounds the graph runner's tokens / "
                    f"lengths / next_pos differ from the eager loop's: {g_len[:, 0]} / "
                    f"{g_pos} against {e_len[:, 0]} / {e_pos}")
            kr.update(eager_rounds=e_rounds, device_capture_ms=gen.decode_runner.capture_ms)
            # device drafts: a whole generation
            st = {}
            dev_out, sec = sync_time(lambda: gen.generate_speculative_device(
                ids, pix, draft_k=k, stats=st))
            dev_state = runner_state(torch, gen.decode_runner)
            kr.update(device_tok_s=b * new / (sec - ttft), device_rounds=st["rounds"],
                      device_rounds_run=st["rounds_run"],
                      noop_rounds=st["rounds_run"] - st["rounds"])
            spec_out[k] = dev_out
            # the verify round's device time, on a fresh prefill
            with torch.inference_mode():
                runner = gen.decode_runner
                state, _ = gen.prefill_into(plan, pix, runner.fresh_cache())
                runner.load(state, 0)
                runner.begin(plan, new)
                del state
                kr["round_ms"] = replay_ms(runner)
            # host drafts. The self oracle drafts the device run's chain; the
            # chain depends, at near ties, on where the rounds cut it (a token
            # verified as a chunk row or read back from the cache sums in
            # another order), so its drafts are not all accepted either. Its
            # first call captures the key: at the largest k, the counted and
            # traced main path of the phase.
            call = lambda stats=None: gen.generate_speculative(  # noqa: E731
                ids, pix, draft=oracle_of(dev_out), draft_k=k, stats=stats)
            if k != SPEC_KS[-1]:
                call()
            else:
                for fn in kc.read_counters():
                    fn.launches = 0
                st = {}
                _, seen = kc.device_launches(lambda: call(st))
                calls = kc.wrapper_calls(dict.fromkeys(kc.read_counters(), 0),
                                         kc.read_counters())
                run = st["rounds"]
                require(calls["extend_kernel"] > 0 and calls["decode_kernel"] == 0,
                        f"spec {name}: wrapper calls {calls}: the M-query kernel's none, or K2's")
                require(seen["extend_kernel"] == layers * run and seen["decode_kernel"] == 0,
                        f"spec {name} k={k}: {seen['extend_kernel']} M-query and "
                        f"{seen['decode_kernel']} K2 launches on the card, not {layers} x "
                        f"{run} rounds and none")
                if gemv_kernel is not None:
                    per_round = e_calls[gemv_kernel] / e_rounds
                    prefill = e_prefill[gemv_kernel]
                    require(per_round == 4 * layers + 1 and calls[gemv_kernel] > 0
                            and seen[gemv_kernel] == prefill + per_round * run,
                            f"spec {name} k={k}: {gemv_kernel} launched {seen[gemv_kernel]} "
                            f"times on the card over {run} rounds, the eager loop "
                            f"{per_round} a round (layer layout: {4 * layers + 1}), a "
                            f"prefill {prefill}")
                kr.update(device_launches=seen, launches=calls, traced_rounds=run)
            kr["host_capture_ms"] = gen.decode_runner.capture_ms
            st = {}
            out, sec = sync_time(lambda: call(st))
            kr.update(self_oracle_rounds=st["rounds"], self_oracle_tok_s=b * new / (sec - ttft),
                      self_oracle_tokens_equal_device=out == dev_out,
                      ceiling_tok_s=b * new / (ttft + -(-new // m) * kr["round_ms"] / 1e3))
            st = {}
            out, sec = sync_time(lambda: gen.generate_speculative(
                ids, pix, draft=oracle_of(ref), draft_k=k, stats=st))
            kr.update(oracle_rounds=st["rounds"], oracle_tok_s=b * new / (sec - ttft),
                      oracle_tokens_equal_device=out == dev_out)
            st = {}
            out, sec = sync_time(lambda: gen.generate_speculative(ids, pix, draft_k=k, stats=st))
            host_state = runner_state(torch, gen.decode_runner)
            require(out == dev_out and all(np.array_equal(x, y)
                                           for x, y in zip(host_state, dev_state)),
                    f"spec {name} k={k}: host- and device-drafted prompt lookup differ: tokens "
                    f"equal {out == dev_out}, lengths / next_pos {host_state[0][:, 0]} / "
                    f"{host_state[1]} against {dev_state[0][:, 0]} / {dev_state[1]}")
            kr.update(lookup_rounds=st["rounds"], lookup_tokens_per_round=st["tokens_per_round"],
                      lookup_tok_s=b * new / (sec - ttft), seconds=time.perf_counter() - t_k)
            r["k"][k] = kr
            log(f"  spec {name} k={k} (M={m}): every draft accepted (TTFT + "
                f"{-(-new // m)} rounds at the verify round's device ms) "
                f"{kr['ceiling_tok_s']:.1f} tok/s; self oracle {kr['self_oracle_rounds']} "
                f"rounds {kr['self_oracle_tok_s']:.1f} tok/s, oracle (plain greedy's chain) "
                f"{kr['oracle_rounds']} rounds {kr['oracle_tok_s']:.1f} tok/s; prompt lookup "
                f"{kr['lookup_tokens_per_round']:.3f} tokens/round {kr['lookup_tok_s']:.1f} "
                f"tok/s; device {kr['device_tok_s']:.1f} tok/s, {kr['device_rounds']} rounds + "
                f"{kr['noop_rounds']} no-op (R={ROUNDS_PER_CHUNK}); verify round "
                f"{kr['round_ms']:.3f} ms against the plain step's {r['plain_step_ms']:.3f} ms; "
                f"capture device {kr['device_capture_ms']:.1f} / host "
                f"{kr['host_capture_ms']:.1f} ms; graph == eager loop over {e_rounds} rounds, "
                f"host == device drafts: ok [{kr['seconds']:.1f} s]")

        # against plain greedy: equal, or apart only at a near tie
        firsts = {k: first_divergence(ref, spec_out[k]) for k in SPEC_KS}
        far = max((j for f in firsts.values() for j in f if j is not None), default=None)
        plain = None if far is None else plain_near_ties(torch, ref_gen, plan, pix, ref, far + 1)
        for k in SPEC_KS:
            ties = {} if plain is None else explain_divergence(cfg, firsts[k], plain,
                                                               spec_margins[k])
            matched = [new if j is None else j for j in firsts[k]]
            r["k"][k].update(matched_prefix=matched, near_ties=ties)
            log(f"  spec {name} k={k}: matched prefix with plain greedy {matched}; near-tie "
                f"bounds {BF16_U:.6f} x sqrt(roundings) x magnitude")
            for i, t in ties.items():
                log(f"    sample {i} leaves plain greedy at token {t['j']}: plain top-two gap "
                    f"{t['gap']:.4g} (bound {t['gap_bound']:.4g}); tightest keep margin before "
                    f"it {t['margin']} (bound {t['margin_bound']})")
            require(all(t["stands"] for t in ties.values()),
                    f"spec {name} k={k}: a divergence from plain greedy at no near tie: {ties}")
        r["seconds"] = time.perf_counter() - t_arm
        log(f"  spec {name}: B={b}, prompt {prompt_len}, TTFT {r['ttft_ms']:.1f} ms, plain "
            f"{r['plain_tok_s']:.1f} tok/s (step {r['plain_step_ms']:.3f} ms, capture "
            f"{r['plain_capture_ms']:.1f} ms) [{r['seconds']:.1f} s]")
        results[f"{label} {name}"] = r
        del gen, ref_gen, runner
    return results


def beam_phase(torch, params, cfg):
    """Phase 5c: ``beam_search`` with ``BEAM_W`` beams on one prompt (an
    image and 60 text tokens) for ``BEAM_NEW`` tokens, EOS off: its wall
    time, and its length-normalised log-probability against greedy's (both
    scored by ``sequence_logprob`` on the card)."""
    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.generation.beam import beam_search, sequence_logprob
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch

    rng = np.random.default_rng(SEED + 8)
    vocab, size = cfg.text.vocab_size, cfg.vision.image_size
    ids = np.concatenate([rng.integers(3, vocab, 30), [IMAGE_TOKEN_INDEX],
                          rng.integers(3, vocab, 30)])
    pix = rng.standard_normal((1, size, size, 3), dtype=np.float32)
    gen = Generator(params, cfg, GenerationConfig(max_new_tokens=BEAM_NEW, eos_token_id=-1))
    greedy = gen.generate([ids], pix)[0]
    w = BEAM_W
    plan_w = plan_batch([ids] * w, cfg.num_image_tokens, pad_multiple=64)
    plan_1 = plan_batch([ids], cfg.num_image_tokens, pad_multiple=64)
    with torch.inference_mode():
        state, _ = gen.prefill_from_plan(plan_w, np.repeat(pix, w, axis=0), BEAM_NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = beam_search(params, cfg, state, w, BEAM_NEW, eos_token_id=-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del state
        scores = []
        for toks in (best, greedy):
            state, _ = gen.prefill_from_plan(plan_1, pix, BEAM_NEW)
            scores.append(sequence_logprob(params, cfg, state, toks) / len(toks))
    require(len(best) == BEAM_NEW and all(0 <= t < vocab for t in best)
            and np.isfinite(scores).all(), f"beam: {best}, scores {scores}")
    res = dict(beams=w, new_tokens=BEAM_NEW, wall_ms=wall * 1e3, logprob_per_token=scores[0],
               greedy_logprob_per_token=scores[1], same_as_greedy=best == greedy)
    log(f"  beam W={w}, {BEAM_NEW} tokens: {wall * 1e3:.1f} ms; length-normalised log-probability "
        f"{scores[0]:.4f} against greedy's {scores[1]:.4f}; first tokens {best[:6]} (greedy "
        f"{greedy[:6]})")
    return res


def continuous_trace(cfg):
    """Phase 5d's requests: each one 336x336 image and 60 text tokens,
    ``CONT_MAX_NEW`` new tokens in turn, one every ``CONT_ARRIVAL_S``."""
    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(SEED + 13)
    vocab, size = cfg.text.vocab_size, cfg.vision.image_size
    return [dict(ids=np.concatenate([rng.integers(3, vocab, 30), [IMAGE_TOKEN_INDEX],
                                     rng.integers(3, vocab, 30)]),
                 pix=rng.standard_normal((size, size, 3), dtype=np.float32),
                 max_new=CONT_MAX_NEW[i % 2], arrival=i * CONT_ARRIVAL_S,
                 sampled=i in CONT_SAMPLED)
            for i in range(CONT_REQUESTS)]


def engine_pass(torch, engine, reqs, sample, timed_arrivals=True, admissions=None):
    """One pass of the trace through a ``ContinuousEngine``: the loop
    submits each request at its arrival time (all at once unless
    ``timed_arrivals``), steps the engine while it has work, and stamps each
    request's fresh tokens on the host clock as ``step`` returns them. The
    requests of ``CONT_SAMPLED`` sample when ``sample``. ``admissions``: a
    dict filled with each admission's ms by batch size, timed between two
    synchronizations. Returns outputs, first / last token seconds, makespan
    and the chunks run."""
    if admissions is not None:
        real = engine._admit_batch

        def timed(slots, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            real(slots, batch)
            torch.cuda.synchronize()
            admissions.setdefault(len(batch), []).append((time.perf_counter() - t) * 1e3)
        engine._admit_batch = timed
    chunks0 = engine.runner.chunks_run
    index, first, last = {}, {}, {}
    nxt, n = 0, len(reqs)
    try:
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            while nxt < n and (not timed_arrivals or reqs[nxt]["arrival"] <= now):
                r = reqs[nxt]
                opts = dict(temperature=0.8, top_p=0.9) if sample and r["sampled"] else {}
                index[engine.submit(r["ids"], r["pix"], max_new_tokens=r["max_new"],
                                    **opts)] = nxt
                nxt += 1
            if engine.idle():
                if nxt == n:
                    break
                time.sleep(max(0.0, reqs[nxt]["arrival"] - now))
                continue
            fresh = engine.step()
            now = time.perf_counter() - t0
            for rid in fresh:
                first.setdefault(index[rid], now)
                last[index[rid]] = now
        makespan = time.perf_counter() - t0
    finally:
        if admissions is not None:
            del engine._admit_batch  # back to the class's method
    outs = [None] * n
    for rid, i in index.items():
        outs[i] = engine.requests.pop(rid).output
    return dict(outputs=outs, first=first, last=last, makespan=makespan,
                chunks=engine.runner.chunks_run - chunks0)


def window_pass(torch, gens, reqs, slots, timed_arrivals=True):
    """The window batcher on the same trace (``run/continuous_bench.py``'s
    window arm): take what has arrived, at most ``slots``, pad it to
    ``slots`` rows, run one ``Generator.generate`` (the one of the batch's
    largest ``max_new``) to its end, repeat. Tokens are stamped as
    ``on_chunk`` streams them; a request's last token is its
    ``max_new``-th. Greedy for every request."""
    outs, first, last, count = [None] * len(reqs), {}, {}, {}
    i, n = 0, len(reqs)
    t0 = time.perf_counter()
    while i < n:
        now = time.perf_counter() - t0
        batch = [j for j in range(i, n)
                 if not timed_arrivals or reqs[j]["arrival"] <= now][:slots]
        if not batch:
            time.sleep(max(reqs[i]["arrival"] - now, 0.001))
            continue
        i = batch[-1] + 1
        rows = batch + [batch[-1]] * (slots - len(batch))

        def on_chunk(k, new, batch=batch):
            if k < len(batch):
                j = batch[k]
                t = time.perf_counter() - t0
                first.setdefault(j, t)
                before = count.get(j, 0)
                count[j] = before + len(new)
                if before < reqs[j]["max_new"] <= count[j]:
                    last[j] = t

        got = gens[max(reqs[j]["max_new"] for j in batch)].generate(
            [reqs[j]["ids"] for j in rows], np.stack([reqs[j]["pix"] for j in rows]),
            pad_to=CONT_BUCKET, on_chunk=on_chunk)
        for j, o in zip(batch, got):
            outs[j] = o[:reqs[j]["max_new"]]
    return dict(outputs=outs, first=first, last=last, makespan=time.perf_counter() - t0)


def pass_stats(reqs, run):
    """Makespan, aggregate tok/s, completion latency (arrival -> last token)
    and TTFT (arrival -> first token), mean and p95, in seconds."""
    done = [run["last"][i] - r["arrival"] for i, r in enumerate(reqs)]
    ttft = [run["first"][i] - r["arrival"] for i, r in enumerate(reqs)]
    tokens = sum(len(o) for o in run["outputs"])
    return dict(makespan_s=run["makespan"], tokens=tokens, tok_s=tokens / run["makespan"],
                latency_mean_s=float(np.mean(done)),
                latency_p95_s=float(np.quantile(done, 0.95)),
                ttft_mean_s=float(np.mean(ttft)), ttft_p95_s=float(np.quantile(ttft, 0.95)))


def hold_to(torch, params, cfg, gc_fields, reqs, ref, got, which, label):
    """Phase 5c's near-tie rule for the engine: each request of ``which``
    has ``got``'s tokens equal ``ref``'s, or leaves them at position j where
    the plain path along ``ref``'s tokens (an eager ``decode_step`` loop of
    the diverging requests, ``plain_near_ties``) has a top-two logit gap or
    an earlier keep margin below ``near_tie_bound`` (``explain_divergence``).
    Returns ``{request: the tie}``."""
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch

    firsts = first_divergence([ref[i] for i in which], [got[i] for i in which])
    div = [(i, j) for i, j in zip(which, firsts) if j is not None]
    if not div:
        return {}
    steps = max(j for _, j in div) + 1
    gen = Generator(params, cfg, GenerationConfig(max_new_tokens=steps, eos_token_id=-1,
                                                  **gc_fields))
    plan = plan_batch([reqs[i]["ids"] for i, _ in div], cfg.num_image_tokens,
                      pad_to=CONT_BUCKET)
    pix = np.stack([reqs[i]["pix"] for i, _ in div])
    tokens = [list(ref[i]) + [0] * (steps - len(ref[i])) for i, _ in div]
    plain = plain_near_ties(torch, gen, plan, pix, tokens, steps)
    ties = explain_divergence(cfg, [j for _, j in div], plain, [[] for _ in div])
    found = {div[k][0]: t for k, t in ties.items()}
    for i, t in found.items():
        log(f"    {label}: request {i} leaves at token {t['j']}: plain top-two gap "
            f"{t['gap']:.4g} (bound {t['gap_bound']:.4g}); tightest keep margin before it "
            f"{t['margin']} (bound {t['margin_bound']})")
    require(all(t["stands"] for t in found.values()),
            f"{label}: a divergence at no near tie: {found}")
    del gen
    return found


def continuous(torch, params, cfg, arms, reqs, holds):
    """Phase 5d: continuous batching at 7B width on the trace ``reqs``,
    one arm ``(name, kind, opts)`` after another on the same weights, each
    prewarmed first on the object that is then timed. ``kind`` "engine":
    a ``ContinuousEngine`` (``CONT_SLOTS`` slots, chunks of ``CONT_CHUNK``,
    bucket ``CONT_BUCKET``, ``max_new_cap`` 128) with ``opts["spec_k"]`` and
    ``opts["gen"]`` (``GenerationConfig`` fields), prewarmed with
    ``ContinuousEngine.prewarm``; "window": the window batcher, one
    ``Generator`` a ``max_new`` value, each prewarmed by one full batch. For
    each arm, the main path: one pass with every request submitted at once,
    the wrappers' counts zeroed just before and read just after and the
    serving kernels' launches counted in a profiler trace of it; then the
    timed pass, requests submitted at their arrival times (admissions timed
    between synchronizations). Checks: an engine's chunks replay graphs
    (no step runs eagerly after its form's capture, no decode / verify
    wrapper is called in the traced pass, K2 (plain) or K2-M (speculative)
    launches once a layer for each step of each chunk on the card, and on
    int8 weights the GEMV kernel ``4 x layers + 1`` times a step), its
    admissions launch K1, its admission cache is one cache of
    ``CONT_SLOTS`` rows at the admission capacities; both passes give the
    same greedy tokens; and for each ``(arm, ref)`` of ``holds`` the arm's
    tokens equal the ref's (every request but those that either arm
    samples), or leave them only at a near tie (``hold_to``). ``opts["int8"]``:
    the weights are int8 (the GEMV count is checked)."""
    import gc

    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.generation.continuous import ContinuousEngine
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator

    layers = cfg.text.num_hidden_layers
    arms_by_name = {a[0]: a for a in arms}
    results, outputs = {}, {}
    for name, kind, opts in arms:
        t_arm = time.perf_counter()
        gen_fields = dict(opts.get("gen", {}))
        spec_k = opts.get("spec_k", 0)
        sample = kind == "engine" and not spec_k
        gc.collect()  # the last arm's runners, graphs and caches
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = dict(kind=kind, **({"spec_k": spec_k} if spec_k else {}), **gen_fields)
        if kind == "engine":
            gen_cfg = GenerationConfig(max_new_tokens=max(CONT_MAX_NEW),
                                       decode_chunk=CONT_CHUNK, eos_token_id=-1, **gen_fields)
            engine = ContinuousEngine(params, cfg, gen_cfg, slots=CONT_SLOTS,
                                      prompt_bucket=CONT_BUCKET, max_new_cap=max(CONT_MAX_NEW),
                                      spec_k=spec_k)
            engine.prewarm(reqs[0]["ids"], reqs[0]["pix"])
            torch.cuda.synchronize()
            runner = engine.runner
            graphs = 1 if spec_k else 2
            require(runner.eager_steps == graphs,
                    f"continuous {name}: {runner.eager_steps} eager steps in prewarm, not one "
                    f"before each of the {graphs} captures")
            capture = ({"verify": runner.capture_ms} if spec_k else
                       {("sampling" if k else "greedy"): v for k, v in
                        runner.captures_ms.items()})
            drive_once = lambda timed, adm=None: engine_pass(  # noqa: E731
                torch, engine, reqs, sample, timed, adm)
        else:
            gens = {mn: Generator(params, cfg, GenerationConfig(
                max_new_tokens=mn, decode_chunk=CONT_CHUNK, eos_token_id=-1, **gen_fields))
                for mn in sorted(set(CONT_MAX_NEW))}
            for mn in gens:
                gens[mn].generate([reqs[0]["ids"]] * CONT_SLOTS,
                                  np.stack([reqs[0]["pix"]] * CONT_SLOTS), pad_to=CONT_BUCKET)
            torch.cuda.synchronize()
            capture = {f"max_new {mn}": g.decode_runner.capture_ms for mn, g in gens.items()}
            drive_once = lambda timed, adm=None: window_pass(  # noqa: E731
                torch, gens, reqs, CONT_SLOTS, timed)
        r.update(prewarm_s=time.perf_counter() - t0, capture_ms=capture)

        # the main path: every request at once, counted and traced
        t0 = time.perf_counter()
        for fn in kc.read_counters():
            fn.launches = 0
        traced_admissions = {}
        main, seen = kc.device_launches(lambda: drive_once(False, traced_admissions))
        calls = kc.wrapper_calls(dict.fromkeys(kc.read_counters(), 0), kc.read_counters())
        r["traced_pass_s"] = time.perf_counter() - t0
        # the timed pass: arrivals at their times
        admissions = {}
        run = drive_once(True, admissions)
        torch.cuda.synchronize()
        r.update(pass_stats(reqs, run))
        r.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                 launches={"K1": seen["flash_fwd"], "K2": seen["decode_kernel"],
                           "K2-M": seen["extend_kernel"],
                           "K5/K6": seen["gemv int8"]},
                 device_launches=seen, wrapper_calls=calls)
        greedy = [i for i in range(len(reqs)) if not (sample and reqs[i]["sampled"])]
        require([main["outputs"][i] for i in greedy] == [run["outputs"][i] for i in greedy],
                f"continuous {name}: the traced and the timed pass differ")
        require(all(len(o) == q["max_new"] for o, q in zip(run["outputs"], reqs))
                and all(0 <= t < cfg.text.vocab_size for o in run["outputs"] for t in o),
                f"continuous {name}: wrong output lengths or token ids")
        require(seen["flash_fwd"] > 0, f"continuous {name}: no K1 launch ({seen})")
        if kind == "engine":
            steps = main["chunks"] * CONT_CHUNK
            r.update(admission_ms={k: float(np.mean(v)) for k, v in sorted(admissions.items())},
                     admissions_by_k={k: len(v) for k, v in sorted(admissions.items())},
                     chunks=run["chunks"], traced_chunks=main["chunks"],
                     cache_gib=cache_bytes(runner.state.cache) / 2**30,
                     admission_pool_gib=cache_bytes(engine.admission_cache) / 2**30)
            kernel, other = (("extend_kernel", "decode_kernel") if spec_k
                             else ("decode_kernel", "extend_kernel"))
            require(runner.eager_steps == graphs and calls[kernel] == 0,
                    f"continuous {name}: a chunk ran eagerly after its capture "
                    f"({runner.eager_steps} eager steps, {calls[kernel]} wrapper calls)")
            require(seen[kernel] == layers * steps and seen[other] == 0,
                    f"continuous {name}: {seen[kernel]} {kernel} launches on the card, not "
                    f"{layers} x {steps} steps, and {seen[other]} {other}")
            if opts.get("int8"):
                # a step: q/k/v, o, gate/up, down a layer and the lm_head; an
                # admission: the lm_head on its k rows (the rest is above 64 rows)
                admits = sum(len(v) for v in traced_admissions.values())
                require(seen["gemv int8"] == (4 * layers + 1) * steps + admits,
                        f"continuous {name}: {seen['gemv int8']} int8 GEMV launches, not "
                        f"{4 * layers + 1} x {steps} steps + {admits} admissions")
            # one cache of CONT_SLOTS rows at the admission capacities: K and V
            # (and the int8 mode's bf16 scales, one a head vector)
            pool = engine.admission_cache
            vec = cfg.text.head_dim * runner.state.cache.pre.k.element_size()
            want_pool = sum(
                2 * t.num_layers * CONT_SLOTS * cap * cfg.text.num_key_value_heads
                * (vec + (2 if t.quantized else 0))
                for t, cap in zip(pool, (engine.admit_pre_cap, engine.admit_post_cap)))
            require(all(t.k.shape[1] == CONT_SLOTS for t in pool)
                    and cache_bytes(pool) == want_pool,
                    f"continuous {name}: the admission pool holds {cache_bytes(pool)} bytes, "
                    f"bound {want_pool}")
        outputs[name] = run["outputs"]
        r.update(samples=sample, seconds=time.perf_counter() - t_arm)
        results[name] = r
        log(f"  continuous {name}: makespan {r['makespan_s']:.3f} s, {r['tok_s']:.1f} tok/s, "
            f"latency mean / p95 {r['latency_mean_s']:.3f} / {r['latency_p95_s']:.3f} s, TTFT "
            f"{r['ttft_mean_s']:.3f} / {r['ttft_p95_s']:.3f} s; admissions "
            f"{r.get('admissions_by_k')} at {r.get('admission_ms')} ms; capture {capture} ms; "
            f"prewarm {r['prewarm_s']:.1f} s; peak {r['peak_gib']:.2f} GiB, cache "
            f"{r.get('cache_gib', 0):.3f} GiB, admission pool {r.get('admission_pool_gib', 0):.3f} "
            f"GiB; traced pass: launches {r['launches']}, wrapper calls {calls} "
            f"[{r['seconds']:.1f} s]")
        if kind == "engine":
            del engine, runner, drive_once
        else:
            del gens, drive_once
    for name, ref in holds:
        t0 = time.perf_counter()
        samples = results[name]["samples"] or results[ref]["samples"]
        which = [i for i in range(len(reqs)) if not (samples and reqs[i]["sampled"])]
        ties = hold_to(torch, params, cfg, dict(arms_by_name[name][2].get("gen", {})), reqs,
                       outputs[ref], outputs[name], which, f"continuous {name} against {ref}")
        results[name].setdefault("held_to", {})[ref] = dict(
            requests=len(which), near_ties=len(ties),
            matched_prefix=[ties[i]["j"] if i in ties else len(outputs[name][i])
                            for i in which])
        log(f"  continuous {name} against {ref}: {len(which)} greedy requests, "
            f"{len(which) - len(ties)} equal, {len(ties)} apart at a near tie "
            f"[{time.perf_counter() - t0:.1f} s]")
    return results


class WordTokenizer:
    """A word-level stand-in for a checkpoint's tokenizer (phase 5e; the
    exported checkpoint has none): the text's words get ids from 3 up as
    they are first seen, ``</s>`` is EOS (2) and BOS (1) leads every
    encoding, as the LLaMA tokenizer's do. An id that no word has decodes
    to ``w<id>`` and encodes back to it, so an answer's text re-encodes to
    its ids."""

    bos_token_id, eos_token_id = 1, 2

    def __init__(self):
        self.words = {0: "<unk>", 1: "<s>", 2: "</s>"}
        self.ids = {w: i for i, w in self.words.items()}

    def _id(self, word: str) -> int:
        if word not in self.ids:
            m = re.fullmatch(r"w(\d+)", word)
            if m:
                return int(m.group(1))
            self.ids[word] = len(self.words)
            self.words[len(self.words)] = word
        return self.ids[word]

    def __call__(self, text: str):
        words = text.replace("</s>", " </s> ").split()
        return types.SimpleNamespace(input_ids=[self.bos_token_id] + [self._id(w) for w in words])

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        return " ".join(self.words.get(int(i), f"w{int(i)}") for i in ids
                        if not (skip_special_tokens and int(i) < 3))


class HostMemory:
    """Peaks of this process's resident memory (``VmRSS``) and of its
    anonymous part (``RssAnon``: not file pages such as a memory-mapped
    checkpoint's), sampled from ``/proc/self/status`` every ``period``
    seconds by a thread between ``start`` and ``stop``, and ``VmRSS`` at
    ``start``."""

    def __init__(self, period: float = 0.02):
        import threading

        # a key the kernel does not report stays None ("not measured")
        self.period, self.peak = period, {"VmRSS": None, "RssAnon": None}
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self) -> dict:
        now = {}
        with open("/proc/self/status") as f:
            for line in f:
                key = line.split(":")[0]
                if key in self.peak:
                    now[key] = int(line.split()[1]) * 1024
                    self.peak[key] = max(self.peak[key] or 0, now[key])
        return now

    def _run(self) -> None:
        while not self.done.is_set():
            self._sample()
            self.done.wait(self.period)

    def start(self) -> "HostMemory":
        self.at_start = self._sample()["VmRSS"]
        self.thread.start()
        return self

    def stop(self) -> dict:
        self.done.set()
        self.thread.join(timeout=5)
        require(not self.thread.is_alive(), "the host-memory sampler did not stop")
        self._sample()
        return {k: None if v is None else v / 2**30
                for k, v in (("rss_gib", self.peak["VmRSS"]), ("anon_gib", self.peak["RssAnon"]),
                             ("rss_start_gib", self.at_start))}


def eval_generators(root, model_path, loaded, images, qfile, traced, layers):
    """Phase 5e: the offline eval generators through ``eval_model(args,
    loaded=...)`` on the loaded runtime, ``CKPT_QUESTIONS`` questions each,
    ``CKPT_MAX_NEW`` new tokens, greedy: ``model_vqa`` on the VQA CLI's
    questions, ``model_vqa_science`` (the last problem text-only),
    ``model_vqa_qbench``, ``model_qa`` (text only: K1 once a decoder layer a
    question, the tower never) and, where ``pandas`` imports,
    ``model_vqa_mmbench`` on a TSV of base64 PNGs. Each answers file must
    hold one record a question. The VQA answers are scored with the TextVQA
    accuracy and the ScienceQA answers with its parser (on random weights:
    this shows that the scorers run, not what they score). The five run in
    one profiler trace (``traced``). Returns each generator's records,
    seconds (traced), K1 launches and texts, the five's launches on the
    card, and the scores."""
    import base64
    import io
    import os
    import random

    from dynamic_llava_tpu_torch.eval import (
        eval_science_qa, model_qa, model_vqa, model_vqa_mmbench, model_vqa_qbench,
        model_vqa_science, vqa_metrics)
    from dynamic_llava_tpu_torch.ops.flash_attention import flash_attention

    n = CKPT_QUESTIONS

    def write(name, text):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            f.write(text)
        return path

    sqa = write("sqa.json", json.dumps([
        {"id": f"p{i}", **({"image": f"q{i}.png"} if i < n - 1 else {}),
         "conversations": [{"from": "human", "value":
                            f"<image>\nWhich animal is in picture {i} ?\nA. a cat\nB. a dog"}]}
        for i in range(n)]))
    qbench = write("qbench.json", json.dumps([
        {"img_path": f"q{i}.png", "question": f"How is the quality of picture {i} ?",
         "candidates": ["good", "poor", "fair"]} for i in range(n)]))
    qa = write("qa.jsonl", "".join(
        json.dumps({"question_id": f"t{i}", "text": f"Describe a dog in {i + 2} words ."}) + "\n"
        for i in range(n)))
    runs = {
        "model_vqa": (model_vqa, ["--image-folder", root, "--question-file", qfile,
                                  "--conv-mode", "llava_v1", "--temperature", "0"], "text"),
        "model_vqa_science": (model_vqa_science, ["--image-folder", root, "--question-file", sqa,
                                                  "--single-pred-prompt"], "text"),
        "model_vqa_qbench": (model_vqa_qbench, ["--image-folder", root, "--questions-file",
                                                qbench], "response"),
        "model_qa": (model_qa, ["--question-file", qa, "--temperature", "0"], "text"),
    }
    try:
        import pandas  # noqa: F401
    except ImportError:
        log("  checkpoint: pandas is absent on this machine: model_vqa_mmbench not run")
    else:
        rows = []
        for i, image in enumerate(images):
            buf = io.BytesIO()
            image.save(buf, format="PNG")
            rows.append(f"{i}\tWhich animal is in picture {i} ?\t\ta cat\ta dog\ta bird\t\t"
                        f"{base64.b64encode(buf.getvalue()).decode()}\n")
        tsv = write("mmbench.tsv", "index\tquestion\thint\tA\tB\tC\tD\timage\n" + "".join(rows))
        runs["model_vqa_mmbench"] = (model_vqa_mmbench, ["--question-file", tsv,
                                                         "--single-pred-prompt"], "text")
    out = {}

    def run_all():
        for name, (mod, argv, key) in runs.items():
            answers = os.path.join(root, f"{name}.jsonl")
            args = mod.parser().parse_args(["--model-path", model_path, "--answers-file",
                                            answers, "--max_new_tokens", str(CKPT_MAX_NEW)] + argv)
            k1 = flash_attention.launches
            t0 = time.perf_counter()
            mod.eval_model(args, loaded=loaded)
            seconds = time.perf_counter() - t0
            with open(answers) as f:
                records = [json.loads(line) for line in f]
            require(len(records) == n, f"checkpoint: {name} wrote {len(records)} records for "
                    f"{n} questions")
            # K1 runs eagerly in the prefill: a wrapper call is a launch
            out[name] = dict(records=len(records), traced_s=seconds,
                             k1_launches=flash_attention.launches - k1,
                             texts=[r[key] for r in records])
            log(f"  checkpoint: {name}: {len(records)} answers in {seconds:.1f} s (traced), "
                f"K1 {out[name]['k1_launches']}")

    # one trace over the five: a trace costs its margins and its processing
    _, seen = traced(run_all)
    log(f"  checkpoint: the generators' launches on the card {seen}")
    qa_k1 = out["model_qa"]["k1_launches"]
    require(qa_k1 == n * layers, f"checkpoint: model_qa launched K1 {qa_k1} times, not once a "
            f"decoder layer a question ({n * layers}): it must run text-only")
    require(seen["flash_fwd"] == sum(g["k1_launches"] for g in out.values()),
            f"checkpoint: the generators' K1 on the card {seen['flash_fwd']} != their wrapper "
            "calls")
    random.seed(SEED)
    scores = {
        "textvqa_accuracy": vqa_metrics.TextVQAAccuracyEvaluator().eval_pred_list(
            [{"pred_answer": t, "gt_answers": ["yes"] * 10} for t in out["model_vqa"]["texts"]]),
        "science_qa_acc": eval_science_qa.score_sqa(
            {f"p{i}": {"choices": ["a cat", "a dog"], "answer": i % 2} for i in range(n)},
            {f"p{i}": {"text": t, "prompt": ""}
             for i, t in enumerate(out["model_vqa_science"]["texts"])})["acc"],
    }
    log(f"  checkpoint: scorers on random weights: {scores}")
    return out, {k: v for k, v in seen.items() if v}, scores


def checkpoint(torch, params, cfg, want_tokens, b=8, n_text=60, then=None):
    """Phase 5e: the phase-5 weights (``params``, the depth of ``cfg``)
    through a checkpoint and the entry points users run.
    ``export_hf_checkpoint`` writes them (bf16) to a temporary directory,
    removed at the end; ``load_pretrained_model`` loads it onto the card,
    and every leaf must be ``torch.equal`` to ``params`` and the config
    equal to ``cfg``. On the loaded runtime: greedy ``Generator.generate``
    of phase 5's sparse batch must give ``want_tokens`` (the same call's on
    ``params``); two rounds of the chat CLI's loop
    (``serve.cli.chat_loop``, a 400x300 image, ``WordTokenizer``) must give
    the answers the same loop gives on the phase-5 weights, K2-M once a
    layer in the continued round. Then the checkpoint is loaded again in
    fp32 (the bf16 weights widened, exactly), and the VQA CLI
    (``model_vqa_loader.eval_model``) on ``CKPT_QUESTIONS`` questions must
    write the same answers plain and with ``--spec_k CKPT_SPEC_K``. The wrappers' counts are zeroed at the
    start and read at the end, the launches on the card counted in profiler
    traces of the generate, chat and VQA calls; K1, K2 and K2-M must each
    launch. Returns the export and load seconds (the tokenizer's first try
    apart), the checkpoint's size, the host's peak RSS (and its anonymous
    part, where the kernel reports it) over export and load, the device's
    peak GiB, and the counts; and what ``then(path)`` returns,
    called at the end with the loads freed, before the checkpoint's
    directory is removed (phase 5f), or None."""
    import os
    import resource
    import tempfile

    from PIL import Image

    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.eval import model_vqa_loader
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.models.builder import (
        LlavaRuntime, load_pretrained_model, load_tokenizer)
    from dynamic_llava_tpu_torch.models.export import export_hf_checkpoint
    from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention, extend_attention
    from dynamic_llava_tpu_torch.ops.flash_attention import flash_attention
    from dynamic_llava_tpu_torch.serve.cli import chat_loop
    from dynamic_llava_tpu_torch.weights import named_leaves

    wrappers = {"flash_fwd": flash_attention, "decode_kernel": decode_attention,
                "extend_kernel": extend_attention}
    for fn in wrappers.values():
        fn.launches = 0
    device = dict.fromkeys(kc.SERVING_KERNELS, 0)

    def traced(fn):
        out, seen = kc.device_launches(fn)
        for k in device:
            device[k] += seen[k]
        return out, seen

    layers = cfg.text.num_hidden_layers
    rng = np.random.default_rng(SEED + 7)
    images = [Image.fromarray(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
              for _ in range(CKPT_QUESTIONS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        path = os.path.join(root, CKPT_NAME)
        host = HostMemory().start()
        try:
            t0 = time.perf_counter()
            export_hf_checkpoint(params, cfg, path)
            export_s = time.perf_counter() - t0
            # the tokenizer's first try timed apart (transformers is imported
            # in phase 2, during the build)
            t0 = time.perf_counter()
            found = load_tokenizer(path)
            tokenizer_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, runtime, processor, ctx = load_pretrained_model(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        finally:
            rss = host.stop()
        load_peak = torch.cuda.max_memory_allocated() / 2**30
        file_gib = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 2**30
        got, ref = list(named_leaves(runtime.params)), list(named_leaves(params))
        require([p for p, _ in got] == [p for p, _ in ref],
                f"checkpoint: loaded leaves {[p for p, _ in got][:8]}... != the phase-5 tree's")
        differ = [p for (p, a), (_, r) in zip(got, ref)
                  if not (a.dtype == r.dtype and a.device == r.device and torch.equal(a, r))]
        require(not differ, f"checkpoint: {len(differ)} loaded leaves differ, e.g. {differ[:4]}")
        require(runtime.cfg == cfg, f"checkpoint: loaded config {runtime.cfg} != {cfg}")
        anon = "not measured" if rss["anon_gib"] is None else f"{rss['anon_gib']:.2f} GiB"
        log(f"  checkpoint: export {export_s:.1f} s ({file_gib:.2f} GiB file), load {load_s:.1f} s "
            f"(after {tokenizer_s:.1f} s for the tokenizer's first try: "
            f"{type(found).__name__}), {len(got)} leaves bit-equal, config equal; host peak "
            f"RSS {rss['rss_gib']:.2f} GiB from {rss['rss_start_gib']:.2f} (anonymous {anon}), "
            f"device peak {load_peak:.2f} GiB")
        del got

        # greedy generate of phase 5's sparse batch on the loaded weights
        gen = Generator(runtime.params, runtime.cfg, GenerationConfig(
            max_new_tokens=64, temperature=0.0, eos_token_id=-1))
        ids, pix = serving_batch(cfg, b, n_text)
        out, seen = traced(lambda: gen.generate(ids, pix))
        require(out == want_tokens, "checkpoint: generate on the loaded weights gave "
                f"{out[0][:8]}..., phase 5 {want_tokens[0][:8]}...")
        log(f"  checkpoint: generate B={b}, 64 tokens == phase 5's; launches {seen}")
        del gen

        # two rounds of the chat CLI's loop, against the same loop on the phase-5 weights
        tok = WordTokenizer()
        kw = dict(conv_mode="llava_v1", temperature=0.0, max_new_tokens=CKPT_MAX_NEW,
                  echo=lambda *a, **k: None)
        answers, seen = traced(lambda: chat_loop(tok, runtime, processor, images[0],
                                                 CKPT_TURNS, **kw))
        ref_answers = chat_loop(tok, LlavaRuntime(params, cfg), processor, images[0],
                                CKPT_TURNS, **kw)
        require(answers == ref_answers, f"checkpoint: chat answers {answers} != the phase-5 "
                f"weights' {ref_answers}")
        require(seen["extend_kernel"] == layers,
                f"checkpoint: chat's continued round launched K2-M {seen['extend_kernel']} "
                f"times, not once a layer ({layers})")
        chat_words = [len(a.split()) for a in answers]
        log(f"  checkpoint: chat {len(answers)} rounds (answers of {chat_words} words) == the "
            f"phase-5 weights'; launches {seen}")

        # the VQA CLI, plain and speculative, on the checkpoint loaded in
        # fp32: on random weights the top two logits sit so close that bf16
        # rounding alone reorders them (phase 5c's near ties), fp32 rounding
        # almost never
        del runtime
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _, runtime, processor, ctx = load_pretrained_model(path, dtype=torch.float32)
        torch.cuda.synchronize()
        load_fp32_s = time.perf_counter() - t0
        require(runtime.cfg == cfg and all(
            torch.equal(a, r.float()) for (_, a), (_, r) in zip(named_leaves(runtime.params), ref)),
            "checkpoint: the fp32 load is not the bf16 weights widened")
        log(f"  checkpoint: loaded again in fp32 in {load_fp32_s:.1f} s")
        for i, image in enumerate(images):
            image.save(os.path.join(root, f"q{i}.png"))
        qfile = os.path.join(root, "questions.jsonl")
        with open(qfile, "w") as f:
            for i in range(CKPT_QUESTIONS):
                f.write(json.dumps({"question_id": i, "image": f"q{i}.png",
                                    "text": f"Is there a dog in picture {i} ?"}) + "\n")
        texts = {}
        for k in (0, CKPT_SPEC_K):
            answers_file = os.path.join(root, f"answers-{k}.jsonl")
            args = model_vqa_loader.parser().parse_args([
                "--model-path", path, "--image-folder", root, "--question-file", qfile,
                "--answers-file", answers_file, "--conv-mode", "llava_v1", "--temperature",
                "0", "--max_new_tokens", str(CKPT_MAX_NEW), "--spec_k", str(k)])
            _, seen = traced(lambda: model_vqa_loader.eval_model(
                args, loaded=(tok, runtime, processor, ctx)))
            with open(answers_file) as f:
                texts[k] = [json.loads(line)["text"] for line in f]
            log(f"  checkpoint: VQA CLI spec_k={k}: {len(texts[k])} answers, launches {seen}")
        require(len(texts[0]) == CKPT_QUESTIONS and texts[CKPT_SPEC_K] == texts[0],
                f"checkpoint: VQA answers plain {texts[0]} != spec_k={CKPT_SPEC_K} "
                f"{texts[CKPT_SPEC_K]}")
        gens, gen_launches, scores = eval_generators(
            root, path, (tok, runtime, processor, ctx), images, qfile, traced, layers)
        require(gens["model_vqa"]["texts"] == texts[0],
                f"checkpoint: model_vqa's answers {gens['model_vqa']['texts']} != the VQA "
                f"CLI's {texts[0]} (both build_prompt, greedy)")
        calls = {k: fn.launches for k, fn in wrappers.items()}
        require(all(device[k] > 0 and calls[k] > 0 for k in wrappers),
                f"checkpoint: a kernel of the path never launched (card {device}, wrappers "
                f"{calls})")
        peak = torch.cuda.max_memory_allocated() / 2**30
        del runtime
        torch.cuda.empty_cache()
        after = None if then is None else then(path)
    return after, dict(export_s=export_s, tokenizer_s=tokenizer_s, load_s=load_s,
                load_fp32_s=load_fp32_s, file_gib=file_gib,
                host_peak_rss_gib=rss["rss_gib"], host_rss_start_gib=rss["rss_start_gib"],
                host_peak_anon_gib=rss["anon_gib"],
                process_max_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
                load_peak_gib=load_peak, peak_gib=peak, chat_answer_words=chat_words,
                vqa_answers=texts[0], device_launches={k: device[k] for k in wrappers},
                wrapper_calls=calls,
                generators={k: {f: v for f, v in g.items() if f != "texts"}
                            for k, g in gens.items()},
                generator_launches=gen_launches, scores=scores)


def serve_requests(tok, processor, cfg, n=SERVE_REQUESTS, seed=SEED + 11):
    """Phase 5f's requests: ``n`` llava_v1 prompts, each a question of 6-12
    words about an image of random pixels of its own size (a PNG, base64,
    as a client sends it), with the token ids and the preprocessed pixels
    the worker makes of them (``ids``, ``pix``)."""
    import base64
    import io

    from PIL import Image

    from dynamic_llava_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
    from dynamic_llava_tpu_torch.conversation import conv_templates
    from dynamic_llava_tpu_torch.mm_utils import process_images, tokenizer_image_token

    rng = np.random.default_rng(seed)
    words = ("what is in the picture where does light fall which colour is the largest "
             "object how many people are there describe scene briefly").split()
    reqs = []
    for i in range(n):
        conv = conv_templates["llava_v1"].copy()
        question = " ".join(rng.choice(words, int(rng.integers(6, 13)))) + " ?"
        conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + question)
        conv.append_message(conv.roles[1], None)
        w, h = int(rng.integers(200, 640)), int(rng.integers(200, 640))
        image = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        buf = io.BytesIO()
        image.save(buf, "PNG")
        prompt = conv.get_prompt()
        reqs.append(dict(
            prompt=prompt, image=base64.b64encode(buf.getvalue()).decode(), stop=conv.sep2,
            ids=np.asarray(tokenizer_image_token(prompt, tok), np.int64),
            pix=process_images([image], processor, cfg)[0]))
    return reqs


def http_stream(url, params):
    """POST ``params`` to ``url`` + ``/worker_generate_stream`` and read the
    b"\\0"-delimited chunks. Returns the chunks, the seconds to the first
    chunk with text past the prompt (the first streamed text: a keep-alive
    ack repeats the prompt alone) and the seconds to the stream's end, on
    the client's clock."""
    import requests

    t0 = time.perf_counter()
    resp = requests.post(url + "/worker_generate_stream", json=params, stream=True,
                         timeout=(15, 600))
    chunks, first = [], None
    for raw in resp.iter_lines(decode_unicode=False, delimiter=b"\0"):
        if raw:
            chunks.append(json.loads(raw.decode()))
            if first is None and chunks[-1]["text"] != params["prompt"]:
                first = time.perf_counter() - t0
    end = time.perf_counter() - t0
    return chunks, end if first is None else first, end


def http_at_once(url, params_list):
    """Every request of ``params_list`` sent together, each from a thread
    of its own; ``(results of http_stream, makespan s)``."""
    out = [None] * len(params_list)

    def run(i):
        out[i] = http_stream(url, params_list[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(params_list))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, time.perf_counter() - t0


class ServeTokenizer(WordTokenizer):
    """Phase 5f's tokenizer: ``WordTokenizer`` whose ``skip_special_tokens``
    skips EOS alone, so that an answer's text (the workers decode with it)
    re-encodes to every token the answer holds."""

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        return " ".join(self.words.get(int(i), f"w{int(i)}") for i in ids
                        if not (skip_special_tokens and int(i) == self.eos_token_id))


def serving(torch, path, cfg):
    """Phase 5f: the serving stack over HTTP at 7B width on phase 5e's
    bf16 checkpoint ``path`` with a word-level stand-in tokenizer
    (``ServeTokenizer``). One
    controller (stdlib, loopback, port 0, shortest queue); one worker at a
    time, each loading the checkpoint itself, served on the stdlib server
    (port 0), registered with the controller, and closed, shut down and
    dropped before the next loads (the controller's ``refresh_all_workers``
    drops a closed one):

    * ``ModelWorker``: SERVE_SENDS greedy image requests of SERVE_MAX_NEW
      tokens through the controller one at a time, then the same ones at
      once, then one sampled; each greedy answer must equal
      ``Generator.generate`` at B=1 on the worker's weights (same shapes,
      same kernels: exact);
    * ``ModelWorker --spec-k SERVE_SPEC_K``: SERVE_SPEC_SENDS greedy
      requests, each equal to that answer or leaving it at a near tie
      (``hold_to``, as phase 5d holds its engines);
    * ``BatchedWorker`` window (``max_batch`` 8): SERVE_REQUESTS requests at
      once; each answer must equal ``Generator.generate`` of the batch the
      worker formed (its ``batch_log``: sizes and order), and the count
      equal to the solo answers is reported;
    * ``BatchedWorker --continuous`` (SERVE_SLOTS slots, bucket CONT_BUCKET):
      the same requests at once, each equal to the window's answer or apart
      at a near tie.

    The K1 / K2 / K2-M wrappers' counts are zeroed just before each send and
    read just after (the comparisons' own launches do not count); each must
    launch (K2-M under ``--spec-k``). No profiler trace. Every chunk must
    have ``error_code`` 0. Returns the ``serving`` line's dict: per arm each
    request's time to first streamed text, completion ms and tok/s (client
    clock), the makespan of the concurrent sends, each worker's load s and
    captures, the device's peak GiB, the wrappers' counts and whether
    ``requests`` imports (the port's HTTP clients use it)."""
    import gc
    import importlib.metadata

    import requests

    from dynamic_llava_tpu_torch import utils

    # the serving modules' log files go to an ignored directory
    utils.LOGDIR = str(ROOT / "build" / "serve_logs")
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.models.builder import load_pretrained_model
    from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention, extend_attention
    from dynamic_llava_tpu_torch.ops.flash_attention import flash_attention
    from dynamic_llava_tpu_torch.serve import controller, http_compat, model_worker, sglang_worker

    t_phase = time.perf_counter()
    tok = ServeTokenizer()
    wrappers = {"flash_fwd": flash_attention, "decode_kernel": decode_attention,
                "extend_kernel": extend_attention}
    served = dict.fromkeys(wrappers, 0)

    def count(fn):
        """``fn()``, the wrappers' counts zeroed just before it and added to
        ``served`` just after."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        for k, w in wrappers.items():
            served[k] += w.launches
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctrl = controller.Controller("shortest_queue")
    capp = http_compat.controller_stdlib_app(ctrl, "127.0.0.1", 0)
    capp.serve(background=True)
    curl = f"http://127.0.0.1:{capp._httpd.server_address[1]}"
    loads, captures, arms = {}, {}, {}
    reqs = None

    def start(name, make):
        """Load the checkpoint, build the worker on it, serve and register
        it."""
        nonlocal reqs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, runtime, processor, ctx = load_pretrained_model(path)
        torch.cuda.synchronize()
        loads[name] = time.perf_counter() - t0
        if reqs is None:
            reqs = serve_requests(tok, processor, cfg)
        worker = make((tok, runtime, processor, ctx))
        del runtime
        app = http_compat.worker_stdlib_app(worker, "127.0.0.1", 0)
        app.serve(background=True)
        worker.controller_addr = curl
        worker.worker_addr = f"http://127.0.0.1:{app._httpd.server_address[1]}"
        worker.register_to_controller()
        require(requests.post(curl + "/refresh_all_workers").status_code == 200,
                "serving: refresh_all_workers failed")
        listed = requests.post(curl + "/get_worker_address", json={"model": CKPT_NAME}).json()
        require(listed == {"address": worker.worker_addr},
                f"serving: the controller dispatches {name} requests to {listed}")
        return worker, app

    def stop(name, worker, app):
        captures[name] = list(worker.captures)
        app.shutdown()
        app._httpd.server_close()
        worker.close()
        gc.collect()
        torch.cuda.empty_cache()

    def params_of(r, **kw):
        return {"model": CKPT_NAME, "prompt": r["prompt"], "images": [r["image"]],
                "temperature": 0.0, "max_new_tokens": SERVE_MAX_NEW, "stop": r["stop"], **kw}

    def answer(r, chunks):
        require(chunks and all(c["error_code"] == 0 for c in chunks),
                f"serving: a request got {chunks[-1] if chunks else 'no chunk'}")
        text = chunks[-1]["text"]
        require(text.startswith(r["prompt"]), "serving: an answer without its prompt")
        return text[len(r["prompt"]):]

    def timings(rs, results, makespan=None):
        """Per request: time to first streamed text and completion ms, tok/s."""
        out = []
        for r, (chunks, first, end) in zip(rs, results):
            n = len(answer(r, chunks).split())  # one word a token (WordTokenizer)
            out.append(dict(first_text_ms=first * 1e3, completion_ms=end * 1e3, tokens=n,
                            tok_s=n / end))
        d = dict(requests=out)
        if makespan is not None:
            d["makespan_s"] = makespan
            d["tok_s"] = sum(o["tokens"] for o in out) / makespan
        return d

    def texts_of(out_ids):
        eos = tok.eos_token_id
        return tok.decode([t for t in out_ids if t != eos], skip_special_tokens=True)

    def tokens_of(text):
        """An answer's tokens, its EOS included where it stopped early."""
        ids = tok(text).input_ids[1:]
        return ids + [tok.eos_token_id] if len(ids) < SERVE_MAX_NEW else ids

    def hold(label, params, ref, got, which):
        """``got``'s answers equal ``ref``'s, or leave them at a near tie."""
        ties = hold_to(torch, params, cfg, {}, reqs, {i: tokens_of(ref[i]) for i in which},
                       {i: tokens_of(got[i]) for i in which}, which, f"serving {label}")
        return dict(requests=len(which), equal=sum(ref[i] == got[i] for i in which),
                    near_ties=len(ties))

    # -- the model worker ----------------------------------------------------
    w, app = start("model_worker", lambda loaded: model_worker.ModelWorker(
        curl, "", "5f", True, path, None, CKPT_NAME, loaded=loaded))
    sends = reqs[:SERVE_SENDS]
    seq = [count(lambda r=r: http_stream(curl, params_of(r))) for r in sends]
    conc, makespan = count(lambda: http_at_once(curl, [params_of(r) for r in sends]))
    sampled = count(lambda: http_stream(curl, params_of(reqs[SERVE_SENDS], temperature=0.7,
                                                         top_p=0.9)))
    answer(reqs[SERVE_SENDS], sampled[0])
    gen = Generator(w.runtime.params, cfg, GenerationConfig(
        max_new_tokens=SERVE_MAX_NEW, eos_token_id=tok.eos_token_id))
    solo = [texts_of(gen.generate([r["ids"]], r["pix"][None])[0]) for r in reqs]
    del gen
    for name, results in (("sequential", seq), ("concurrent", conc)):
        got = [answer(r, c) for r, (c, _, _) in zip(sends, results)]
        require(got == solo[:SERVE_SENDS], f"serving: the model worker's {name} answers "
                f"{[g[:40] for g in got]} != Generator.generate's {[s[:40] for s in solo]}")
    arms["model_worker sequential"] = timings(sends, seq)
    arms["model_worker concurrent"] = timings(sends, conc, makespan)
    arms["model_worker sampled"] = timings(reqs[SERVE_SENDS:SERVE_SENDS + 1], [sampled])
    arms["model_worker sampled"]["seed"] = w.global_counter
    require(w.global_counter == 2 * SERVE_SENDS + 1,
            f"serving: the worker counted {w.global_counter} requests")
    log(f"  serving: model worker, {SERVE_SENDS} greedy requests one at a time and at once "
        f"== Generator.generate at B=1; 1 sampled; captures {w.captures}; load "
        f"{loads['model_worker']:.1f} s")
    stop("model_worker", w, app)

    # -- the model worker under --spec-k --------------------------------------
    w, app = start("model_worker spec_k", lambda loaded: model_worker.ModelWorker(
        curl, "", "5f-spec", True, path, None, CKPT_NAME, spec_k=SERVE_SPEC_K,
        loaded=loaded))
    spec = [count(lambda r=r: http_stream(curl, params_of(r))) for r in reqs[:SERVE_SPEC_SENDS]]
    got = {i: answer(reqs[i], c) for i, (c, _, _) in enumerate(spec)}
    arms[f"model_worker spec_k={SERVE_SPEC_K}"] = dict(
        timings(reqs[:SERVE_SPEC_SENDS], spec),
        held=hold(f"spec_k={SERVE_SPEC_K} against Generator.generate", w.runtime.params,
                  dict(enumerate(solo)), got, list(got)))
    require(served["extend_kernel"] > 0, "serving: --spec-k never launched K2-M")
    log(f"  serving: model worker --spec-k {SERVE_SPEC_K}: "
        f"{arms[f'model_worker spec_k={SERVE_SPEC_K}']['held']}; captures {w.captures}")
    stop("model_worker spec_k", w, app)

    # -- the batched worker: window micro-batches ----------------------------
    w, app = start("window", lambda loaded: sglang_worker.BatchedWorker(
        path, max_batch=8, batch_window_ms=SERVE_WINDOW_MS, model_name=CKPT_NAME, loaded=loaded))
    win, makespan = count(lambda: http_at_once(curl, [params_of(r) for r in reqs]))
    window = {i: answer(r, c) for i, (r, (c, _, _)) in enumerate(zip(reqs, win))}
    by_prompt = {r["prompt"]: i for i, r in enumerate(reqs)}
    batches = []
    for b in w.batch_log:
        idx = [by_prompt[p] for p in b["prompts"]]
        gen = Generator(w.runtime.params, cfg, GenerationConfig(
            max_new_tokens=b["max_new"], eos_token_id=tok.eos_token_id))
        outs = gen.generate([reqs[i]["ids"] for i in idx], np.stack([reqs[i]["pix"] for i in idx]))
        del gen
        require([window[i] for i in idx] == [texts_of(o) for o in outs],
                f"serving: the window worker's batch {idx} != Generator.generate of that batch")
        batches.append(idx)
    require(sorted(i for b in batches for i in b) == list(range(len(reqs))),
            f"serving: the window worker's batches {batches} do not hold every request once")
    arms["window"] = dict(timings(reqs, win, makespan), batches=batches,
                          equal_solo=sum(window[i] == solo[i] for i in window))
    log(f"  serving: window worker, {len(reqs)} requests at once in batches {batches}, each "
        f"== Generator.generate of its batch; {arms['window']['equal_solo']} of {len(reqs)} "
        f"== the solo answers; captures {w.captures}")
    stop("window", w, app)

    # -- the batched worker: continuous --------------------------------------
    w, app = start("continuous", lambda loaded: sglang_worker.BatchedWorker(
        path, model_name=CKPT_NAME, continuous=True, slots=SERVE_SLOTS, prompt_bucket=CONT_BUCKET,
        max_new_cap=SERVE_MAX_NEW, loaded=loaded))
    cont, makespan = count(lambda: http_at_once(curl, [params_of(r) for r in reqs]))
    got = {i: answer(r, c) for i, (r, (c, _, _)) in enumerate(zip(reqs, cont))}
    arms["continuous"] = dict(timings(reqs, cont, makespan),
                              held=hold("continuous against the window worker",
                                        w.runtime.params, window, got, list(got)))
    log(f"  serving: continuous worker ({SERVE_SLOTS} slots), {len(reqs)} requests at once: "
        f"{arms['continuous']['held']}; captures {w.captures}")
    stop("continuous", w, app)
    capp.shutdown()
    capp._httpd.server_close()

    require(all(served[k] > 0 for k in wrappers),
            f"serving: a kernel of the path never launched (wrapper calls {served})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = dict(arms=arms, load_s=loads, captures=captures, peak_gib=peak,
               wrapper_calls=served, requests_version=importlib.metadata.version("requests"),
               phase_s=time.perf_counter() - t_phase)
    for name, r in arms.items():
        firsts = [q["first_text_ms"] for q in r["requests"]]
        done = [q["completion_ms"] for q in r["requests"]]
        log(f"  serving {name}: first text {min(firsts):.0f}-{max(firsts):.0f} ms, completion "
            f"{min(done):.0f}-{max(done):.0f} ms"
            + (f", makespan {r['makespan_s']:.2f} s, {r['tok_s']:.1f} tok/s"
               if "makespan_s" in r else ""))
    log(f"  serving: peak {peak:.2f} GiB, wrapper calls {served}, requests "
        f"{out['requests_version']} [{out['phase_s']:.1f} s]")
    return out


def ppl_tools(torch, path, params, cfg, device="cuda", sizes=None):
    """Phase 5g: the generation-quality probes and the bench core at 7B
    width (the checkpoint's depth), on phase 5e's checkpoint ``path`` (loaded
    again in fp32, ``WordTokenizer``) and on the phase-5 bf16 weights ``params``
    (bit-equal to the checkpoint's bf16 load, phase 5e). Each tool through
    the entry a user calls (``eval_model(args, loaded=...)``, ``visualize``,
    ``bench_config``, ``long_text_memory``): ``run_llava_for_ppl`` (one
    image prompt; its greedy tokens must equal ``Generator.generate`` at
    B=1 on the same load, padded to the same length: (a)),
    ``model_vqa_science_for_ppl`` (two problems), ``model_lvis_for_ppl``
    sparse and dense (two records, answers of ``answer_words`` words; the
    dense record's PPL must equal exp of the mean NLL of one dense
    ``forward_nocache_eval`` pass over the prompt + answer prefixes within
    ``PPL_RTOL`` relative: (b); sparse, the prefill's post tier must be
    shorter than its pre tier and the decode tokens persisted at most the
    answer's: (c)), ``model_lvis_for_meteor`` (two records),
    ``model_lvis_multi_round`` in ppl mode (``PPL_ROUNDS`` rounds: K2-M
    once a layer a continued round), ``visualize`` (the keep budget kept);
    then on the bf16 weights ``bench_config`` sparse and dense (B, prompt,
    new tokens and prefill repetitions of ``sizes``: its greedy tokens and
    cache capacities must equal ``Generator.generate``'s and
    ``Generator.cache_sizes``' for the same batch: (d)) and
    ``long_text_memory`` at one length. The K1 / K2 / K2-M wrappers are
    zeroed at the start and read at the end (no trace). Returns the
    ``ppl_tools`` and ``bench_core`` records and the wrapper calls."""
    import os
    import tempfile

    from PIL import Image

    from dynamic_llava_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
    from dynamic_llava_tpu_torch.conversation import conv_templates
    from dynamic_llava_tpu_torch.eval import (
        bench, bench_test, model_lvis_for_meteor, model_lvis_for_ppl, model_lvis_multi_round,
        model_vqa_science_for_ppl, run_llava_for_ppl, visualize)
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.mm_utils import process_images, tokenizer_image_token
    from dynamic_llava_tpu_torch.models import dynamic
    from dynamic_llava_tpu_torch.models.builder import LlavaRuntime, load_pretrained_model
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
    from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention, extend_attention
    from dynamic_llava_tpu_torch.ops.flash_attention import flash_attention

    sz = dict(PPL_SIZES, **(sizes or {}))
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    wrappers = {"flash_fwd": flash_attention, "decode_kernel": decode_attention,
                "extend_kernel": extend_attention}
    for fn in wrappers.values():
        fn.launches = 0
    t_phase = time.perf_counter()
    tools, timings = {}, {}

    def run(name, fn):
        """``fn()`` timed (synchronized), with its wrapper calls."""
        before = {k: w.launches for k, w in wrappers.items()}
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        timings[name] = dict(seconds=time.perf_counter() - t0, wrapper_calls={
            k: w.launches - before[k] for k, w in wrappers.items()})
        return out

    rng = np.random.default_rng(SEED + 13)
    words = ("a red cat sits on the old wooden table near the window while light falls "
             "across its fur and two birds watch from outside").split()

    def sentence(n):
        return " ".join(rng.choice(words, n)) + " ."

    question = "Describe the picture in detail ."
    layers = cfg.text.num_hidden_layers
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ppl_") as root:
        images = []
        for i in range(2):
            img = Image.fromarray(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
            img.save(os.path.join(root, f"q{i}.png"))
            images.append(img)

        def write(name, rows, lines=True):
            p = os.path.join(root, name)
            with open(p, "w") as f:
                f.write("".join(json.dumps(r) + "\n" for r in rows) if lines
                        else json.dumps(rows))
            return p

        lvis = write("lvis.jsonl", [
            {"question_id": i, "image": f"q{i}.png", "text": question,
             "answer": sentence(sz["answer_words"])} for i in range(2)])
        sqa = write("sqa.json", [
            {"id": f"p{i}", "image": f"q{i}.png",
             "conversations": [{"value": "<image>\nWhat is in the picture ?"}]}
            for i in range(2)], lines=False)
        multi = write("multi.jsonl", [{"question_id": 0, "image": "q0.png", "rounds": [
            {"text": question if r == 0 else f"And what is in corner {r} ?",
             "answer": sentence(sz["round_words"])} for r in range(sz["rounds"])]}])
        tok = WordTokenizer()
        t0 = time.perf_counter()
        _, runtime, proc, ctx = load_pretrained_model(path, dtype=torch.float32, device=dev)
        sync()
        load_s = time.perf_counter() - t0
        loaded = (tok, runtime, proc, ctx)
        base = ["--model-path", path, "--conv-mode", "llava_v1", "--device", str(dev)]
        new = ["--max_new_tokens", str(sz["max_new"])]

        # (a) run_llava_for_ppl against Generator.generate at B=1
        args = run_llava_for_ppl.parser().parse_args(
            base + new + ["--image-file", os.path.join(root, "q0.png"), "--query", question])
        res = run("run_llava_for_ppl", lambda: run_llava_for_ppl.eval_model(args, loaded=loaded))
        conv = conv_templates["llava_v1"].copy()
        conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + question)
        conv.append_message(conv.roles[1], None)
        ids = np.asarray(tokenizer_image_token(conv.get_prompt(), tok), np.int64)
        pix = process_images([images[0]], proc, runtime.cfg)
        n_img = runtime.cfg.num_image_tokens
        gen = Generator(runtime.params, runtime.cfg, GenerationConfig(
            max_new_tokens=sz["max_new"], eos_token_id=tok.eos_token_id))
        ref = gen.generate([ids], pix, pad_to=plan_batch([ids], n_img).seq_len)[0]
        del gen
        if ref and ref[-1] == tok.eos_token_id:
            ref = ref[:-1]
        require(res["tokens"] == ref, f"ppl tools: run_llava_for_ppl's tokens "
                f"{res['tokens'][:8]}... != Generator.generate's {ref[:8]}...")
        tools["run_llava_for_ppl"] = dict(self_ppl=res["self_ppl"],
                                          answer_token_len=res["answer_token_len"])

        args = model_vqa_science_for_ppl.parser().parse_args(
            base + new + ["--image-folder", root, "--question-file", sqa, "--temperature", "0",
                          "--answers-file", os.path.join(root, "sqa_ppl.jsonl")])
        mean = run("model_vqa_science_for_ppl",
                   lambda: model_vqa_science_for_ppl.eval_model(args, loaded=loaded))
        with open(args.answers_file) as f:
            recs = [json.loads(line) for line in f]
        require(len(recs) == 3 and math.isfinite(mean) and mean >= 1.0,
                f"ppl tools: science records {len(recs)}, mean self-PPL {mean}")
        tools["model_vqa_science_for_ppl"] = dict(
            mean_self_ppl=mean, self_ppl=[float(r["self_ppl"]) for r in recs[:-1]],
            answer_token_len=[int(r["answer_token_len"]) for r in recs[:-1]])

        # (b), (c): the LVIS teacher-forced probe, sparse and dense
        dense = LlavaRuntime(runtime.params, bench.dense_config(runtime.cfg))
        for mode, rt in (("sparse", runtime), ("dense", dense)):
            args = model_lvis_for_ppl.parser().parse_args(
                base + ["--image-folder", root, "--question-file", lvis,
                        "--answers-file", os.path.join(root, f"lvis_{mode}.jsonl")])
            tools[f"model_lvis_for_ppl {mode}"] = run(
                f"model_lvis_for_ppl {mode}",
                lambda: model_lvis_for_ppl.eval_model(args, loaded=(tok, rt, proc, ctx)))
        for rec in tools["model_lvis_for_ppl sparse"]:
            require(rec["prefill_cache_length"] < rec["prefill_full_length"]
                    and 0 <= rec["output_cache_length"] <= rec["output_token_length"]
                    and math.isfinite(rec["ppl"]),
                    f"ppl tools: sparse LVIS record {rec}")
        dense_rec = tools["model_lvis_for_ppl dense"][0]
        with open(lvis) as f:
            answer = json.loads(f.readline())["answer"]
        answer_ids = tok(answer).input_ids[1:]
        conv = conv_templates["llava_v1"].copy()
        conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + question)
        conv.append_message(conv.roles[1], None)
        prompt = np.asarray(tokenizer_image_token(conv.get_prompt(), tok), np.int64)
        prefixes = [np.concatenate([prompt, np.asarray(answer_ids[:t], np.int64)])
                    for t in range(len(answer_ids))]
        plan = plan_batch(prefixes, n_img)
        pix_t = torch.from_numpy(np.repeat(pix, len(prefixes), axis=0)).to(dev)

        def forward():
            with torch.inference_mode():
                return dynamic.forward_nocache_eval(
                    dense.params, dense.cfg, *bench_test.plan_tensors(plan, dev, True), pix_t)

        logits, kept = run("forward_nocache_eval dense", forward)
        logp = torch.log_softmax(logits.double(), dim=-1)
        nll = -logp[torch.arange(len(answer_ids)), torch.tensor(answer_ids)]
        ppl_fwd = float(torch.exp(nll.mean()))
        require(torch.equal(kept.cpu(), torch.as_tensor(np.asarray(plan.valid_len))),
                "ppl tools: the dense forward dropped tokens")
        ppl_rel = abs(dense_rec["ppl"] - ppl_fwd) / ppl_fwd
        require(ppl_rel <= PPL_RTOL, f"ppl tools: dense teacher-forced PPL {dense_rec['ppl']} != "
                f"{ppl_fwd} of one forward_nocache_eval pass (rel {ppl_rel:.2e} > {PPL_RTOL})")
        tools["forward_nocache_eval dense"] = dict(ppl=ppl_fwd, rel_diff=ppl_rel,
                                                   rows=len(prefixes), seq_len=plan.seq_len)
        del logits, logp, pix_t

        args = model_lvis_for_meteor.parser().parse_args(
            base + new + ["--image-folder", root, "--question-file", lvis,
                          "--answers-file", os.path.join(root, "meteor.jsonl")])
        recs = run("model_lvis_for_meteor",
                   lambda: model_lvis_for_meteor.eval_model(args, loaded=loaded))
        require(len(recs) == 2 and all(0 < r["prefill_cache_length"] for r in recs),
                f"ppl tools: meteor records {recs}")
        tools["model_lvis_for_meteor"] = [
            {k: r[k] for k in ("meteor", "output_token_length", "prefill_cache_length")}
            for r in recs]

        args = model_lvis_multi_round.parser().parse_args(
            base + new + ["--image-folder", root, "--question-file", multi, "--mode", "ppl",
                          "--answers-file", os.path.join(root, "multi.jsonl")])
        recs = run("model_lvis_multi_round",
                   lambda: model_lvis_multi_round.eval_model(args, loaded=loaded))[0]["rounds"]
        # a wrapper counts launches: none on the CPU, where it runs its plain version
        k2m = timings["model_lvis_multi_round"]["wrapper_calls"]["extend_kernel"]
        require(len(recs) == sz["rounds"] and k2m == (sz["rounds"] - 1) * layers * cuda,
                f"ppl tools: multi-round {len(recs)} rounds, K2-M {k2m} wrapper calls "
                f"(once a layer a continued round: {(sz['rounds'] - 1) * layers})")
        pre = [r["pre_cache_length"] for r in recs]
        require(pre == sorted(set(pre)) and all(math.isfinite(r["ppl"]) for r in recs),
                f"ppl tools: multi-round records {recs}")
        tools["model_lvis_multi_round"] = recs

        args = visualize.parser().parse_args(
            ["--model-path", path, "--image-file", os.path.join(root, "q1.png"), "--output",
             os.path.join(root, "kept.png"), "--conv-mode", "llava_v1", "--device", str(dev)])
        grid, _ = run("visualize", lambda: visualize.visualize(args, loaded=loaded))
        budget = runtime.cfg.sparse.vision_keep_budget(n_img)
        require(int(grid.sum()) == budget, f"ppl tools: visualize kept {int(grid.sum())} "
                f"patches, not the budget {budget}")
        tools["visualize"] = dict(kept=int(grid.sum()), patches=int(grid.size))
        # the fp32 load goes before the bench (its loop variable and the
        # forward's closure hold it too)
        del loaded, runtime, dense, rt, forward, proc
        if cuda:
            torch.cuda.empty_cache()

    # the bench core on the bf16 weights
    b, text_len, new_tokens = sz["bench_batch"], sz["bench_text"], sz["bench_new"]
    core = {}
    for mode, c in (("sparse", cfg), ("dense", bench.dense_config(cfg))):
        toks = []
        r = run(f"bench_config {mode}", lambda: bench.bench_config(
            params, c, batch=b, text_len=text_len, new_tokens=new_tokens,
            prefill_reps=sz["bench_reps"], tokens=toks))
        ids_b, imgs = bench.random_prompts(c, b, text_len)
        imgs = bench.bf16_pixels(imgs)
        g = Generator(params, c, bench.bench_generation_config(new_tokens)._replace(
            decode_chunk=32))
        gen_toks = g.generate(ids_b, imgs)
        plan_b = plan_batch(ids_b, c.num_image_tokens, max_length=c.model_max_length,
                            pad_multiple=1)
        caps = g.cache_sizes(plan_b, imgs, new_tokens)
        del g
        require(gen_toks == toks, f"bench core {mode}: bench_config's tokens {toks[0][:8]}... "
                f"!= Generator.generate's {gen_toks[0][:8]}...")
        require(caps == (r["pre_cache_capacity"], r["post_cache_capacity"]),
                f"bench core {mode}: capacities {r['pre_cache_capacity']}, "
                f"{r['post_cache_capacity']} != Generator.cache_sizes {caps}")
        core[mode] = r
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    core["long_text_memory"] = run("long_text_memory", lambda: bench_test.long_text_memory(
        params, cfg, batch=1, text_len=text_len, max_new=sz["long_new"],
        checkpoint_every=sz["long_every"]))
    pre = [r["pre_cache_length"] for r in core["long_text_memory"]]
    require(np.all(np.diff(pre) == sz["long_every"]),
            f"bench core: long_text_memory pre-tier lengths {pre}")
    calls = {k: w.launches for k, w in wrappers.items()}
    require(all(v > 0 for v in calls.values()) or not cuda,
            f"ppl tools: a kernel of the path never launched (wrapper calls {calls})")
    phase_s = time.perf_counter() - t_phase
    for name, t in timings.items():
        log(f"  ppl tools: {name}: {t['seconds']:.2f} s, wrapper calls {t['wrapper_calls']}")
    log(f"  ppl tools: fp32 load {load_s:.1f} s; (a) run_llava_for_ppl == generate "
        f"({len(ref)} tokens); (b) dense PPL {dense_rec['ppl']:.6g} vs one forward "
        f"{ppl_fwd:.6g} (rel {ppl_rel:.2e}); (c) sparse prefill "
        f"{[(r['prefill_cache_length'], r['prefill_full_length']) for r in tools['model_lvis_for_ppl sparse']]}"
        f", decode kept {[(r['output_cache_length'], r['output_token_length']) for r in tools['model_lvis_for_ppl sparse']]}")
    for mode in ("sparse", "dense"):
        r = core[mode]
        log(f"  bench core {mode}: (d) tokens and capacities == Generator's; TTFT "
            f"{r['ttft_ms']:.1f} ms (device {r['ttft_device_ms']:.1f}), decode "
            f"{r['decode_tok_s']:.1f} tok/s, capacities {r['pre_cache_capacity']:.0f} / "
            f"{r['post_cache_capacity']:.0f}, peak {r['peak_est_gb']:.2f} GiB")
    log(f"  phase 5g: {phase_s:.1f} s, wrapper calls {calls}")
    return dict(tools=tools, timings=timings, load_s=load_s, phase_s=phase_s,
                wrapper_calls=calls), core


def gate_configs():
    """The gates' configs at the JAX tests' values: the vision gate's sparse
    and dense configs, the text gate's, and its dense one."""
    from dynamic_llava_tpu_torch.run import sparse_quality as sq
    from dynamic_llava_tpu_torch.run import text_sparse_quality as tq

    return (sq.make_cfg(64, 3, 0.2, sparse_layer=0),
            sq.make_cfg(64, 3, 1.0, use_vision_predictor=False, sparse_layer=0),
            tq.make_cfg(64, 3, 0), tq.make_cfg(64, 3, 0, use_output_text_predictor=False))


def gate_eval_on_card_and_cpu(torch):
    """Phase 4b's plain check of the gates' evaluation path: ``eval_arm`` of
    both gates at their configs on the same random weights (seed 0, fp32),
    the vision gate's learned and random arms, the text gate's dense and
    random arms (its keep decisions all from the override), on the card (K1
    in the tower and the prefill, K2 in each decode step) and on the CPU
    (plain versions). The
    discrete metrics (accuracy, F1, kept shares, keep rates) must be equal,
    PPL and margin within 1e-3 relative (fp32, rounded to 4 decimals)."""
    from dynamic_llava_tpu_torch.run import sparse_quality as sq
    from dynamic_llava_tpu_torch.run import text_sparse_quality as tq
    from dynamic_llava_tpu_torch.weights import init_llava_params, map_leaves

    cont = ("holdout_answer_ppl", "answer_margin", "recall_ppl")
    vcfg, _, tcfg, tdense = gate_configs()
    p, a, im, sig, lab = sq.build_corpus(16, vcfg.vision.image_size, vcfg.vision.patch_size,
                                         seed=SEED)
    corpus = tq.build_corpus(16, 2, seed=SEED)
    rng = np.random.default_rng(SEED + 7)
    scores = rng.uniform(size=(16, vcfg.num_image_tokens))
    t = corpus.answers.shape[1]
    keep = (rng.uniform(size=(t - 1, 16)) < 0.5).astype(np.int32)
    arms = [("vision learned@0.2", vcfg, lambda prm, dev: sq.eval_arm(
                 prm, vcfg, p, a, im, sig, lab, device=dev)),
            ("vision random@0.2", vcfg, lambda prm, dev: sq.eval_arm(
                 prm, vcfg, p, a, im, sig, lab, score_override=scores, device=dev)),
            ("text dense", tdense, lambda prm, dev: tq.eval_arm(prm, tdense, corpus,
                                                                 device=dev)),
            ("text random@0.5", tcfg, lambda prm, dev: tq.eval_arm(
                 prm, tcfg, corpus, keep_override=keep, device=dev))]
    for name, cfg, evaluate in arms:
        cpu = init_llava_params(cfg, torch.Generator().manual_seed(SEED), "cpu", torch.float32)
        rows = {dev: evaluate(map_leaves(lambda _, x: x.to(dev), cpu), dev)
                for dev in ("cpu", "cuda")}
        log(f"  eval {name}, card: {json.dumps(rows['cuda'])}")
        for k, want in rows["cpu"].items():
            got = rows["cuda"][k]
            same = (abs(got - want) <= 1e-3 * abs(want) + 1e-4) if k in cont else got == want
            require(same, f"eval {name}: {k} on the card {got} != on the CPU {want}")


def gate_train_on_card_and_cpu(torch):
    """Phase 4b's plain check of the gates' training path: ``GATE_CHECK_STEPS``
    steps of each training stage of both gates (dense, then with the
    predictor: the vision gate's ``train_sparse``, the text gate's
    ``train_lm``) from the same random weights (seed 0, fp32, the
    predictors made as ``run_all`` makes them) on the same uniform Gumbel
    noise, on the card (K1 / K3 in the dense stages, K4 in the sparse ones)
    and on the CPU (plain versions). The last step's ``lm_loss`` must agree
    within 1e-4 relative, so that what the gates measure on the card is the
    training the CPU runs, not a kernel's fault."""
    from dynamic_llava_tpu_torch.run import sparse_quality as sq
    from dynamic_llava_tpu_torch.run import text_sparse_quality as tq
    from dynamic_llava_tpu_torch.weights import init_llava_params, init_predictors, map_leaves

    vcfg, vdense, tcfg, tdense = gate_configs()
    p, a, im, _, _ = sq.build_corpus(32, vcfg.vision.image_size, vcfg.vision.patch_size,
                                     seed=SEED)
    n, b = GATE_CHECK_STEPS, 32
    s_vision = len(p[0]) + 1 + vcfg.num_image_tokens
    s_text = len(tq.PROMPT) + tq.build_corpus(1, 2).answers.shape[1]

    def vision(cfg, prm, dev, nz):
        return sq.train_sparse(cfg, p, a, im, n, params=prm, device=dev, noise=nz)

    def text(cfg, prm, dev, nz):
        return tq.train_lm(cfg, 2, n, batch_size=b, params=prm, predictor_lr=6e-3, device=dev,
                           noise=nz)

    stages = [("vision dense", vdense, s_vision, vision),
              ("vision sparse", vcfg, s_vision, vision),
              ("text dense", tdense, s_text, text), ("text sparse", tcfg, s_text, text)]
    rng = np.random.default_rng(SEED + 3)
    for name, cfg, s, train in stages:
        cpu = init_llava_params(cfg, torch.Generator().manual_seed(SEED), "cpu", torch.float32)
        if cfg.sparse.any_predictor:
            cpu["predictors"] = init_predictors(
                cfg, torch.Generator().manual_seed(SEED + 1), "cpu", torch.float32,
                text_keep_bias=3.0 if cfg.sparse.use_output_text_predictor else 0.0)
        draws = [[np.clip(rng.uniform(size=shape), 1e-12, None).astype(np.float32)
                  for shape in ((b, cfg.num_image_tokens, 2), (b, s, 2), (b, s, 2))]
                 for _ in range(n)]
        losses = {}
        for dev in ("cpu", "cuda"):
            prm = map_leaves(lambda _, x: x.clone().to(dev), cpu)
            _, losses[dev] = train(cfg, prm, dev, lambda i, dev=dev: [
                torch.from_numpy(u).to(dev) for u in draws[i]])
        log(f"  train {name}: lm_loss after {n} steps card {losses['cuda']:.6f}, "
            f"CPU {losses['cpu']:.6f}")
        require(abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"]),
                f"train {name}: lm_loss on the card {losses['cuda']} != on the CPU "
                f"{losses['cpu']}")


def quality_gates(torch):
    """Phase 4b: the port's quality gates on the card (``dynamic_llava_tpu_torch.run``)
    at the JAX tests' configs and step counts, fp32, seed 0: the vision
    gate, the output-text gate and the train-then-evaluate chain, each
    trained and evaluated through the kernels (head_dim 16, zero-padded to
    64 by the attention wrappers). The launch counters of K1, K3, K4 and K2
    (and of K5 / K6 for the chain's int8 answers) are zeroed before each
    and must rise in it (K4 runs only under a predictor, so not in the
    chain); every row must be finite. The JAX tests' thresholds
    (``gate_failures`` of each harness) are computed for each gate and
    printed; the text gate's and the chain's must hold. The vision gate's
    are reported, not required: the JAX harness itself meets them at seed 0
    with the CPU's default thread count and misses them with one thread,
    and at seeds 1 and 2 (ROADMAP C20, PERF.md's Findings), so their pass is
    a property of one trajectory of its training. What the kernels must get
    right is held apart, card against CPU, by ``gate_train_on_card_and_cpu``
    and ``gate_eval_on_card_and_cpu``."""
    import contextlib
    import io

    from dynamic_llava_tpu_torch.ops import flash_attention as fa
    from dynamic_llava_tpu_torch.ops import quant_matmul as qm
    from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention
    from dynamic_llava_tpu_torch.ops.flash_policy import flash_policy_attention
    from dynamic_llava_tpu_torch.run import quant_quality as qq
    from dynamic_llava_tpu_torch.run import sparse_quality as sq
    from dynamic_llava_tpu_torch.run import text_sparse_quality as tq

    gate_train_on_card_and_cpu(torch)
    gate_eval_on_card_and_cpu(torch)
    counters = {"K1": (fa.flash_attention,),
                "K3": (fa.flash_attention_bwd_delta, fa.flash_attention_bwd_dq,
                       fa.flash_attention_bwd_dkv),
                "K4": (flash_policy_attention,), "K2": (decode_attention,),
                "K5/K6": (qm.q8_gemv, qm.q8_gemv_group)}
    dense_v = GATE_VISION_STEPS
    dense_t, sparse_t = GATE_TEXT_STEPS
    gates = [
        ("vision", {"steps": dense_v + dense_v},
         lambda: sq.run_all(steps=dense_v, pairs=32, holdout=32, hidden=64, layers=3,
                            dense_steps=dense_v, sparse_layer=0, seed=SEED, device="cuda"),
         lambda res: sq.gate_failures(*res), ("K1", "K3", "K4", "K2"), False),
        ("text", {"steps": dense_t + sparse_t},
         lambda: tq.run_all(steps=sparse_t, batch=32, holdout=32, hidden=64, layers=3, k=2,
                            sparse_layer=0, seed=SEED, dense_steps=dense_t,
                            predictor_lr=6e-3, device="cuda"),
         lambda res: tq.gate_failures(*res), ("K1", "K3", "K4", "K2"), True),
        ("train-eval", {"steps": GATE_CHAIN_STEPS},
         lambda: qq.run_gate(steps=GATE_CHAIN_STEPS, device="cuda"),
         qq.gate_failures, ("K1", "K3", "K2", "K5/K6"), True),
    ]
    out = {}
    for name, info, run, failures, need, held in gates:
        for fns in counters.values():
            for fn in fns:
                fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the harness's own JSON lines
            res = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: sum(fn.launches for fn in fns) for k, fns in counters.items()}
        fails = failures(res)
        if name == "train-eval":
            rows = {"chain": {"lm_loss": res["lm_loss"],
                              **{f"{key}_{m}": res[key][m] for key in ("pope", "pope_int8")
                                 for m in ("accuracy", "f1")}}}
            gaps = None
        else:
            rows, gaps = res
        out[name] = dict(info, seconds=round(secs, 1), rows=rows, gaps=gaps,
                         launches=launches, thresholds_failed=fails, thresholds_held=held)
        log(f"  gate {name}: {secs:.1f} s, {info['steps']} train steps; launches {launches}")
        for arm, row in rows.items():
            log(f"    {arm}: {json.dumps(row)}")
        log(f"    gaps {json.dumps(gaps)}; JAX thresholds "
            + (f"failed: {fails}" if fails else "met") + ("" if held else " (reported)"))
        require(all(launches[k] > 0 for k in need),
                f"gate {name}: a kernel of its path did not launch: {launches}")
        require(all(np.isfinite(v) for row in rows.values() for v in row.values()
                    if v is not None), f"gate {name}: a row is not finite: {rows}")
        require(not (held and fails), f"gate {name}: thresholds not met: {fails}")
    return out


def first_layers(llm: dict, n: int) -> dict:
    """A decoder's params cut to its first ``n`` layers: views of the
    stacked layer weights, the embedding, final norm and lm_head shared."""
    def cut(tree):
        return {k: cut(v) if isinstance(v, dict) else v[:n] for k, v in tree.items()}

    return {**llm, "layers": cut(llm["layers"])}


def kv_cosine(torch, params, cfg, b=8, n_text=60):
    """Phase 7, KV quality: on ``params`` (the int4 decoder), B=``b`` requests
    (one image and ``n_text`` tokens each, as ``serve`` makes them) are
    prefilled with a bf16, an int8 and an fp8 KV cache; the bf16 run
    decodes greedily and its tokens are fed to the other two (teacher
    forcing, so errors do not compound). At each of ``COSINE_STEPS`` the
    cosine of each sample's last logits against the bf16 run's; every one
    must be finite. Returns ``{cache: {step: [min, mean]}}``."""
    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.models.dynamic import decode_step
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch

    rng = np.random.default_rng(SEED)
    vocab, size = cfg.text.vocab_size, cfg.vision.image_size
    ids = [np.concatenate([rng.integers(3, vocab, n_text // 2), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, vocab, n_text - n_text // 2)])
           for _ in range(b)]
    pix = rng.standard_normal((b, size, size, 3), dtype=np.float32)
    steps = max(COSINE_STEPS)
    logits, tokens = {}, None
    for kv in ("bfloat16", "int8", "float8_e4m3fn"):
        gc = GenerationConfig(max_new_tokens=steps, temperature=0.0, eos_token_id=-1,
                              cache_dtype=kv)
        plan = plan_batch(ids, cfg.num_image_tokens, pad_multiple=gc.pad_multiple)
        gen = Generator(params, cfg, gc)
        got, fed = {}, []
        with torch.inference_mode():
            state, _ = gen.prefill_from_plan(plan, pix, steps)
            for i in range(steps):
                tok = torch.argmax(state.last_logits, dim=-1) if tokens is None else tokens[i]
                state = decode_step(gen.params, gen.cfg, tok, state)
                fed.append(tok)
                if i + 1 in COSINE_STEPS:
                    got[i + 1] = state.last_logits.float().clone()
        tokens = fed if tokens is None else tokens
        logits[kv] = got
        del gen, state
        torch.cuda.empty_cache()
    out = {}
    for kv in ("int8", "float8_e4m3fn"):
        out[kv] = {}
        for step in COSINE_STEPS:
            cos = torch.nn.functional.cosine_similarity(logits[kv][step],
                                                        logits["bfloat16"][step], dim=-1)
            require(bool(torch.isfinite(cos).all()), f"KV cosine {kv} step {step}: {cos}")
            out[kv][step] = [cos.min().item(), cos.mean().item()]
        log(f"  KV cosine against bf16 KV, {kv}: " + ", ".join(
            f"step {st}: min {v[0]:.6f} mean {v[1]:.6f}" for st, v in out[kv].items()))
    return out


def remat_policies(torch, cfg_sparse):
    """Phase 9b: the JAX package's remat policies at 7B width (B=4, S=1663,
    bf16). First the gradients: on ``REMAT_CHECK_DEPTH`` layers, the same
    fresh weights, batch and noise for every policy, one step each; every
    gradient leaf must match ``nothing``'s within ``BF16_TOL`` of its max
    |grad| (the recompute repeats the same arithmetic). Then each policy's
    ``Trainer`` for REMAT_STEPS sparse steps at the largest of
    ``REMAT_DEPTHS`` that fits the card (an out-of-memory error frees
    everything and takes the next), with K1 (the CLIP tower's apart), K3
    and K4 counted: once a layer and step under ``flash``, ``flash_dots``
    and ``alternate``, twice under ``nothing`` and ``dots``. Returns each
    policy's measurements."""
    import gc

    from dynamic_llava_tpu_torch.train.optimizer import label_params, make_optimizer
    from dynamic_llava_tpu_torch.train.step import batch_from_plan, make_train_step
    from dynamic_llava_tpu_torch.weights import init_llava_params

    dev = torch.device("cuda")

    def at_depth(depth):
        return dataclasses.replace(
            cfg_sparse, text=dataclasses.replace(cfg_sparse.text, num_hidden_layers=depth))

    check = at_depth(REMAT_CHECK_DEPTH)
    plan, images = train_batch(check, TRAIN_BATCH, TRAIN_TEXT_LEN)
    batch = batch_from_plan(plan, images, dev)
    ref, grad_err = None, {}
    for policy in REMAT_POLICIES:
        params = init_llava_params(check, torch.Generator(device=dev).manual_seed(SEED + 3), dev,
                                   torch.bfloat16)
        opt = make_optimizer()
        step = make_train_step(check, opt, remat=True, remat_policy=policy,
                               labels=label_params(params))
        step(params, opt.init(params), batch, torch.Generator(device=dev).manual_seed(SEED), 1.0)
        grads = step.grad_buffers
        if ref is None:
            ref = {p: g.clone() for p, g in grads.items()}
        else:
            require(sorted(grads) == sorted(ref), f"remat {policy}: other gradient leaves")
            worst = max(((grads[p].float() - ref[p].float()).abs().max().item()
                         / max(ref[p].float().abs().max().item(), 1e-30), p) for p in ref)
            grad_err[policy] = worst[0]
            log(f"  remat {policy}: first-step gradients at depth {REMAT_CHECK_DEPTH} against "
                f"nothing's: max |diff| / max |grad| {worst[0]:.3e} (at {worst[1]}; "
                f"tolerance {BF16_TOL})")
            require(worst[0] <= BF16_TOL, f"remat {policy}: gradients differ from nothing's")
        del params, opt, step, grads
        torch.cuda.empty_cache()
    del ref, batch
    torch.cuda.empty_cache()

    vis = cfg_sparse.vision
    clip_layers = vis.num_hidden_layers + vis.select_layer + 1
    sl = cfg_sparse.sparse.sparse_layer
    out = {}
    for policy in REMAT_POLICIES:
        runs = 1 if policy in ("flash", "flash_dots", "alternate") else 2
        for depth in REMAT_DEPTHS:
            cfg = at_depth(depth)
            expect = {"flash_attention_fwd": clip_layers + runs * sl,
                      "flash_attention_bwd_delta": sl, "flash_attention_bwd_dq": sl,
                      "flash_attention_bwd_dkv": sl,
                      "flash_policy_attention_fwd": runs * (depth - sl)}
            params = init_llava_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 1),
                                       dev, torch.bfloat16)
            try:
                r = train(torch, params, cfg, f"remat {policy}", expect, steps=REMAT_STEPS,
                          remat_policy=policy)
            except torch.cuda.OutOfMemoryError:
                r = None
                log(f"  remat {policy}: out of memory at depth {depth}")
            del params
            gc.collect()
            torch.cuda.empty_cache()
            if r is not None:
                r["decoder_k1_launches_per_step"] = r["launches_per_step"][
                    "flash_attention_fwd"] - clip_layers
                r["clip_k1_launches_per_step"] = clip_layers
                r["grad_max_rel_diff"] = grad_err.get(policy, 0.0)
                out[policy] = r
                break
        require(policy in out, f"remat {policy}: no depth of {REMAT_DEPTHS} fits the card")
    return out


def qlora(torch, cfg_sparse):
    """Phase 9c: QLoRA at 7B width: an int4 decoder made directly with
    rank-``LORA_RANK`` bf16 adapters on all seven targets, ``lora_mode``,
    REMAT_STEPS sparse steps of ``Trainer.train`` (B=4, S=1663, remat
    ``nothing``, lr 2e-4 and a projector lr of 2e-5 as in
    ``run/finetune_qlora.sh``): the loss finite, every base leaf (int4
    values, scales, norms, embedding) byte-equal after, every adapter's B
    changed in every layer. Then greedy ``generate`` with the adapters
    attached (B=8, 16 new tokens) with ``DYNAMIC_LLAVA_Q4_MLP=1``: K7 and
    K8 must launch and K9 never (every MLP leaf has an adapter), and the
    tokens must equal an eager loop's (``eager_decode``)."""
    import os
    import tempfile

    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
    from dynamic_llava_tpu_torch.ops import quant_matmul as qm
    from dynamic_llava_tpu_torch.ops.quant import init_quantized_llama_params
    from dynamic_llava_tpu_torch.train.lora import attach_lora, init_lora_params
    from dynamic_llava_tpu_torch.train.trainer import Trainer, TrainerConfig
    from dynamic_llava_tpu_torch.weights import init_llava_params, named_leaves, param_bytes

    dev = torch.device("cuda")
    text = cfg_sparse.text
    params = init_llava_params(
        dataclasses.replace(cfg_sparse, text=dataclasses.replace(text, num_hidden_layers=0)),
        torch.Generator(device=dev).manual_seed(SEED + 4), dev, torch.bfloat16)
    params["llm"] = init_quantized_llama_params(
        text, torch.Generator(device=dev).manual_seed(SEED + 4), dev, bits=4)
    adapters = init_lora_params(text, torch.Generator(device=dev).manual_seed(SEED + 5),
                                rank=LORA_RANK, alpha=LORA_ALPHA, dtype=torch.bfloat16,
                                device=dev)
    params = attach_lora(params, adapters)
    base = {p: t.clone() for p, t in named_leaves(params["llm"]) if "_lora" not in p}
    log(f"  int4 decoder {param_bytes(base) / 2**30:.2f} GiB, adapters "
        f"{param_bytes(adapters) / 2**30:.3f} GiB (rank {LORA_RANK}, all seven targets)")
    plan, images = train_batch(cfg_sparse, TRAIN_BATCH, TRAIN_TEXT_LEN)
    b, s = plan.token_ids.shape
    with tempfile.TemporaryDirectory() as out_dir:
        tc = TrainerConfig(output_dir=out_dir, num_train_steps=100, warmup_ratio=0.01,
                           logging_steps=1, save_steps=0, report_to="none", seed=SEED,
                           learning_rate=2e-4, mm_projector_lr=2e-5, lora_mode=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg_sparse, params, tc)
        times, losses = [], []
        for _ in range(REMAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.train([(plan, images)]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        params = trainer.params
        del trainer
    require(all(np.isfinite(m["loss"]) for m in losses), f"qlora: losses {losses}")
    leaves = dict(named_leaves(params["llm"]))
    changed = [p for p, t in base.items() if not torch.equal(leaves[p], t)]
    require(not changed, f"qlora: base leaves changed: {changed}")
    for name in adapters:
        bl = params["llm"]["layers"][name]["b"]
        require(bool((bl != 0).flatten(1).any(1).all()), f"qlora: {name} B did not change")
    del base
    step_s = sum(times[1:]) / len(times[1:])
    r = dict(first_step_s=times[0], step_ms=step_s * 1e3, tok_s=b * s / step_s, peak_gib=peak,
             depth=text.num_hidden_layers, rank=LORA_RANK,
             losses=[{k: m[k] for k in ("loss", "lm_loss")} for m in losses])
    log(f"  qlora: depth {r['depth']}, B={b}, S={s}; first step {times[0]:.3f} s, then "
        f"{r['step_ms']:.1f} ms/step ({r['tok_s']:.1f} tok/s), peak {peak:.2f} GiB; "
        f"losses {r['losses']}; base byte-equal, every adapter B moved")

    rng = np.random.default_rng(SEED)
    vocab, size = text.vocab_size, cfg_sparse.vision.image_size
    ids = [np.concatenate([rng.integers(3, vocab, 30), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, vocab, 30)]) for _ in range(8)]
    pix = rng.standard_normal((8, size, size, 3), dtype=np.float32)
    gc_ = GenerationConfig(max_new_tokens=16, temperature=0.0, eos_token_id=-1)
    gen = Generator(params, cfg_sparse, gc_)
    os.environ[Q4_MLP_SWITCH] = "1"
    try:
        for fn in (qm.q4_gemv, qm.q4_gemv_group, qm.q4_mlp):
            fn.launches = 0
        out = gen.generate(ids, pix)
        got = {"q4_gemv": qm.q4_gemv.launches, "q4_gemv_group": qm.q4_gemv_group.launches,
               "q4_mlp": qm.q4_mlp.launches}
        plan_g = plan_batch(ids, cfg_sparse.num_image_tokens, pad_multiple=gc_.pad_multiple)
        ref, _, _ = eager_decode(torch, gen, plan_g, pix, 16)
    finally:
        os.environ.pop(Q4_MLP_SWITCH, None)
    log(f"  qlora generate (B=8, 16 tokens, adapters attached, fused MLP switched on): "
        f"wrapper calls {got}")
    require(got["q4_gemv"] > 0 and got["q4_gemv_group"] > 0 and got["q4_mlp"] == 0,
            f"qlora generate: K7 / K8 must launch and K9 never: {got}")
    require(np.array_equal(np.asarray(out).T, ref),
            "qlora generate: the graph's tokens differ from the eager loop's")
    r["generate_launches"] = got
    return r


def write_word_tokenizer(out_dir, corpus) -> str:
    """A word-level tokenizer directory trained on ``corpus`` with
    ``tokenizers`` (``<unk>`` 0, ``<s>`` 1 leading every encoding, ``</s>``
    2), as a LLaMA tokenizer numbers them, and the ``tokenizer_config.json``
    that ``AutoTokenizer`` reads."""
    import os

    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from tokenizers.processors import TemplateProcessing

    tok = Tokenizer(models.WordLevel(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(corpus, trainers.WordLevelTrainer(
        special_tokens=["<unk>", "<s>", "</s>"]))
    tok.post_processor = TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", tok.token_to_id("<s>"))])
    os.makedirs(out_dir, exist_ok=True)
    tok.save(os.path.join(out_dir, "tokenizer.json"))
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>",
                   "eos_token": "</s>", "unk_token": "<unk>", "model_max_length": 2048}, f)
    return out_dir


def write_train_set(root, n_image=CLI_IMAGE_RECORDS, n_text=CLI_TEXT_RECORDS,
                    words=CLI_WORDS, turn_words=CLI_TURN_WORDS, seed=SEED):
    """A LLaVA-format JSON set of v1 conversations under ``root``: ``n_image``
    records with an image (PNGs of random pixels in ``CLI_IMAGE_SIZES``:
    mixed aspect ratios, so the ``pad`` path squares them) and ``n_text``
    text-only ones, each of two rounds of ``turn_words`` words a turn (text
    records of ``1.5 x`` as many, so that both fuse to ~1.6k tokens at 7B),
    drawn from ``words`` synthetic words. Returns ``(data_path,
    image_folder, corpus)``; the corpus holds every text the tokenizer
    must know."""
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)
    vocab = [f"t{i}" for i in range(words)]
    images = os.path.join(root, "images")
    os.makedirs(images, exist_ok=True)

    def turn(n):
        return " ".join(rng.choice(vocab, n + int(rng.integers(-8, 9))))

    records = []
    for i in range(n_image + n_text):
        n = turn_words if i < n_image else turn_words * 3 // 2
        conv = []
        for r in range(2):
            q = turn(n)
            if i < n_image and r == 0:
                q = "<image>\n" + q
            conv += [{"from": "human", "value": q}, {"from": "gpt", "value": turn(n)}]
        rec = {"id": f"cli{i}", "conversations": conv}
        if i < n_image:
            w, h = CLI_IMAGE_SIZES[i % len(CLI_IMAGE_SIZES)]
            name = f"{i}.png"
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(images, name))
            rec["image"] = name
        records.append(rec)
    data = os.path.join(root, "data.json")
    with open(data, "w") as f:
        json.dump(records, f)
    corpus = [" ".join(vocab), "A chat between a curious user and an artificial intelligence "
              "assistant . The assistant gives helpful , detailed , and polite answers to the "
              "user ' s questions . USER : ASSISTANT :"]
    return data, images, corpus


class CliWatch:
    """Wraps ``Trainer.train`` and ``Trainer.save`` for one run of the
    training CLI: the time ``train`` begins (``time.time``, the clock of
    the metrics stream), each batch's fused length and valid lengths as the
    trainer takes it, and each save's seconds (synchronized) and bytes."""

    def __init__(self, torch):
        from dynamic_llava_tpu_torch.train.trainer import Trainer

        self.torch, self.cls = torch, Trainer
        self.orig = (Trainer.train, Trainer.save)
        self.train_t0, self.lengths, self.saves = None, [], []

    def __enter__(self):
        watch, (train, save) = self, self.orig

        def train_wrap(trainer, batches):
            def record():
                for plan, images in batches:
                    watch.lengths.append([plan.seq_len] + plan.valid_len.tolist())
                    yield plan, images
            watch.torch.cuda.synchronize()
            watch.train_t0 = time.time()
            return train(trainer, record())

        def save_wrap(trainer):
            import os

            watch.torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save(trainer)
            watch.saves.append((time.perf_counter() - t0, os.path.getsize(path)))
            return path

        self.cls.train, self.cls.save = train_wrap, save_wrap
        return self

    def __exit__(self, *exc):
        self.cls.train, self.cls.save = self.orig


def train_cli(torch, expect, need_bytes):
    """Phase 9d: the training CLI (``train.train_sparse.train``, in this
    process so that its launches are counted) at LLaVA-1.5-7B width, full
    depth, bf16, random weights from its ``--seed``: ``--max_steps
    CLI_STEPS`` sparse steps at ``--per_device_train_batch_size
    TRAIN_BATCH`` over a JSON set this phase writes (``write_train_set``:
    images through the data pipeline's ``pad`` path, native where ``g++``
    builds it) with a word-level tokenizer it writes
    (``write_word_tokenizer``; ``AutoTokenizer``'s first load timed apart),
    then the CLI's unconditional final save into a temporary directory
    (room for ``need_bytes`` required first; removed at the end). The
    losses must be finite, K1 / K3 / K4 launch ``expect`` (phase 9's
    sparse step) a step, and the checkpoint file must exist. Returns the
    step times (host clock of the metrics stream; a step includes its
    batch's loading; the first apart), the batches' fused lengths, the
    peak, the save's seconds and bytes, and whether the native image path
    ran."""
    import os
    import shutil
    import tempfile

    from dynamic_llava_tpu_torch import native
    from dynamic_llava_tpu_torch.ops import flash_attention as fa
    from dynamic_llava_tpu_torch.ops.flash_policy import flash_policy_attention
    from dynamic_llava_tpu_torch.train import train_sparse

    counters = {"flash_attention_fwd": fa.flash_attention,
                "flash_attention_bwd_delta": fa.flash_attention_bwd_delta,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "flash_policy_attention_fwd": flash_policy_attention}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_cli_") as root:
        free = shutil.disk_usage(root).free
        require(free >= need_bytes, f"train_cli: {free / 2**30:.1f} GiB free under {root}, the "
                f"final save needs ~{need_bytes / 2**30:.1f} GiB")
        t0 = time.perf_counter()
        data, images, corpus = write_train_set(root)
        tok_dir = write_word_tokenizer(os.path.join(root, "tokenizer"), corpus)
        data_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(tok_dir, use_fast=False)
        tokenizer_s = time.perf_counter() - t0
        try:
            import sentencepiece  # noqa: F401
            has_sentencepiece = True
        except ImportError:
            has_sentencepiece = False
        out_dir = os.path.join(root, "out")
        argv = ["--model_size", "7b", "--tokenizer_path", tok_dir, "--data_path", data,
                "--image_folder", images, "--per_device_train_batch_size", str(TRAIN_BATCH),
                "--max_steps", str(CLI_STEPS), "--logging_steps", "1", "--output_dir", out_dir]
        native_calls = native.clip_preprocess_batch_native.calls
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with CliWatch(torch) as watch:
            trainer = train_sparse.train(argv)
        cli_s = time.perf_counter() - t0
        got = {n: fn.launches for n, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        native_calls = native.clip_preprocess_batch_native.calls - native_calls
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        ckpt = os.path.join(out_dir, "ckpt", f"step_{CLI_STEPS}.pt")
        saved = os.path.isfile(ckpt)
        depth = trainer.cfg.text.num_hidden_layers
        del trainer
    torch.cuda.empty_cache()
    want = {n: c * CLI_STEPS for n, c in expect.items()}
    require(got == want, f"train_cli: launches {got} != {want} (phase 9's sparse step "
            f"x {CLI_STEPS})")
    require([m["step"] for m in metrics] == list(range(1, CLI_STEPS + 1)),
            f"train_cli: logged steps {[m['step'] for m in metrics]}")
    losses = [{k: m[k] for k in ("loss", "lm_loss", "image_mask_loss", "output_text_mask_loss",
                                 "grad_norm") if k in m} for m in metrics]
    require(all(np.isfinite(v) for m in losses for v in m.values()) and
            all(m["lm_loss"] > 0 for m in losses), f"train_cli: losses {losses}")
    require(saved and len(watch.saves) == 1, f"train_cli: no checkpoint at {ckpt}")
    stamps = [watch.train_t0] + [m["time"] for m in metrics]
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    r = dict(depth=depth, batch=TRAIN_BATCH, steps=CLI_STEPS, first_step_ms=step_ms[0],
             step_ms=step_ms[1:], fused_lengths=watch.lengths, peak_gib=peak,
             save_s=watch.saves[0][0], save_bytes=watch.saves[0][1], cli_s=cli_s,
             tokenizer_s=tokenizer_s, data_s=data_s, native_image_path=native_calls > 0,
             native_calls=native_calls, sentencepiece=has_sentencepiece,
             tokenizer=type(tokenizer).__name__, launches=got,
             launches_per_step={n: c // CLI_STEPS for n, c in got.items()}, losses=losses)
    log(f"  train_cli: depth {depth}, B={TRAIN_BATCH}, {CLI_STEPS} steps in {cli_s:.1f} s; first step "
        f"{step_ms[0]:.1f} ms, then {' / '.join(f'{ms:.1f}' for ms in step_ms[1:])} ms; fused "
        f"lengths {watch.lengths}; peak {peak:.2f} GiB; final save {watch.saves[0][0]:.1f} s, "
        f"{watch.saves[0][1] / 2**30:.2f} GiB; native image path "
        f"{'ran' if native_calls else 'did not run'} ({native_calls} calls); tokenizer "
        f"{r['tokenizer']} first load {tokenizer_s:.1f} s; launches {got}; losses {losses}")
    return r


def logits_hold(got, ref):
    """``(max |got - ref|, bound)`` of two bf16 paths' fp32 logits, the
    bound ``LOGITS_HOLD_REL`` of the reference's largest magnitude. Two
    paths that compute the same function round in other places: K1 rounds
    its probabilities to bf16 for the tensor cores, K2 and the plain path
    keep them in fp32, and every attention output and residual add rounds
    to bf16 after sums in another order; on random weights the layers
    amplify that (on an H100: at 7B width 0.14-0.18 on logits up to 5.6 on
    32 layers' anyres decode rows, none on the prefill's rows that share
    its kernels; 0.11-0.16 on up to ~6 for 8 Mistral layers; with fp32
    weights 0.004, the bf16 cache's rounding). A wrong row, position, mask
    or feature moves logits by their own magnitude (Mistral without its
    window: 8.1 on up to ~6)."""
    err = float((got.float() - ref.float()).abs().max())
    return err, LOGITS_HOLD_REL * float(ref.float().abs().max())


def teacher_forced_logits(torch, params, cfg, gen, plan, feats, tokens, steps):
    """An eager loop along ``tokens`` (the greedy tokens a sample, from the
    graph) on the anyres prefill of ``plan``: the prefill's last logits and
    each step's, ``[steps + 1, B, V]``, and the near-tie record of
    ``explain_divergence`` (top-two gaps, top logits, keep margins)."""
    from dynamic_llava_tpu_torch.models.dynamic import decode_step

    logits, gaps, tops, margins = [], [], [], []
    with torch.inference_mode(), KeepMargins() as rec:
        state, _ = gen.prefill_anyres(plan, feats, HIRES_MAX_NEW)
        for j in range(steps + 1):
            last = state.last_logits.float()
            logits.append(last.clone())
            top2 = torch.topk(last, 2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
            tops.append(top2[:, 0].abs().cpu().numpy())
            if j == steps:
                break
            tok = torch.tensor([t[j] for t in tokens], device=gen.device)
            n = len(rec.calls)
            state = decode_step(params, cfg, tok, state)
            margins.append(next(((a.cpu().numpy(), sc.cpu().numpy())
                                 for a, sc in rec.calls[n:]), None))
    return torch.stack(logits), (np.stack(gaps), np.stack(tops), margins)


def nocache_logits(torch, params, cfg, gen, plan, feats, tokens, steps):
    """The no-cache reference of the cached path: the plan's fused
    embeddings (tokens + the merged anyres features) with each sample's
    first ``steps`` generated tokens appended, through
    ``run_layers_nocache`` + ``lm_head`` (K1, no cache, no runner, no
    planner); the logits at each sample's last prompt row and the next
    ``steps`` rows, ``[steps + 1, B, V]``."""
    from dynamic_llava_tpu_torch.models import llama
    from dynamic_llava_tpu_torch.multimodal.fusion import fuse_embeddings

    dev = gen.device
    b = plan.batch
    valid = [int(v) for v in plan.valid_len]
    s = max(valid) + steps
    ids = np.zeros((b, s), np.int64)
    is_img = np.zeros((b, s), bool)
    slot = np.zeros((b, s), np.int32)
    for i in range(b):
        ids[i, :valid[i]] = plan.token_ids[i, :valid[i]]
        ids[i, valid[i]:valid[i] + steps] = tokens[i][:steps]
        is_img[i, :valid[i]] = plan.is_image[i, :valid[i]]
        slot[i, :valid[i]] = plan.image_slot[i, :valid[i]]
    with torch.inference_mode():
        x = llama.embed_tokens(params["llm"], torch.from_numpy(ids).to(dev))
        x = fuse_embeddings(x, torch.from_numpy(feats).to(dev), torch.from_numpy(is_img).to(dev),
                            torch.from_numpy(slot).to(dev))
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        h = llama.run_layers_nocache(params["llm"], cfg.text, x, pos)
        rows = torch.tensor([[valid[i] - 1 + j for i in range(b)] for j in range(steps + 1)],
                            device=dev)  # [steps + 1, B]
        picked = h[torch.arange(b, device=dev)[None, :], rows]  # [steps + 1, B, D]
        return llama.lm_head(params["llm"], cfg.text, picked)


def hires(torch, params, cfg_sparse, device="cuda", sizes=None):
    """Phase 5h: high resolution and the other towers at 7B width, 32
    layers, on the phase-5 bf16 weights (and a random ``image_newline``
    leaf), ``model_max_length`` 4096 and the LLaVA-1.6 grid pinpoints:
    ``Generator.generate_anyres`` at B=2 on a 672x672 and a 1008x336 image
    (random pixels), HIRES_MAX_NEW tokens, dense and sparse, and each image
    alone at B=1; ``s2_tower_features`` at S2_SCALES; TokenPacker's tower
    taps and projector (random bf16 weights at 7B width, raw grid 24, scale
    factor 2); ``preprocess_batch`` on two uint8 frames. Holds: (a) the
    merged token counts equal ``merge_anyres_features``' on the host from
    the images' geometry; (b) dense, the prefill's last logits and the
    first HIRES_CHECK_STEPS decode steps' lie within ``logits_hold``'s
    bound of ``run_layers_nocache`` + ``lm_head`` over the same fused
    embeddings and generated tokens; (c) each row's tokens at B=2 equal its
    tokens alone at B=1, or leave them at a near tie (``explain_divergence``
    on the B=2 path); (d) S2's first channel block equals
    ``vision_tower_features``; (e) TokenPacker's output is [1, 144, 4096]
    and finite; (f) on-device preprocessing lies within
    ``tests/test_preprocess.py``'s bounds of the port's PIL pipeline. The
    K1 / K2 wrappers are zeroed at its start and read at its end (no
    trace); each must launch. ``device="cpu"`` with ``sizes`` (``pinpoints``,
    ``images``, ``s2_scales``, ``tp_layers``, ``frame``) for a tiny config
    rehearses the phase on the plain versions. Returns the ``hires``
    record."""
    from PIL import Image

    from dynamic_llava_tpu_torch.config import DENSE_SPARSE_CONFIG, IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.mm_utils import (
        ClipImagePreprocessor, expand2square, get_anyres_image_grid_shape)
    from dynamic_llava_tpu_torch.models import clip, towers
    from dynamic_llava_tpu_torch.multimodal.anyres import merge_anyres_features
    from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention
    from dynamic_llava_tpu_torch.ops.flash_attention import flash_attention
    from dynamic_llava_tpu_torch.ops.preprocess import preprocess_batch

    sz = {**dict(pinpoints=HIRES_PINPOINTS, images=HIRES_SIZES, s2_scales=S2_SCALES,
                 tp_layers=TP_LAYERS, frame=(480, 640)), **(sizes or {})}
    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for fn in (flash_attention, decode_attention):
        fn.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(SEED + 5)
    vis = cfg_sparse.vision
    d = cfg_sparse.text.hidden_size
    dtype = params["llm"]["final_ln"].dtype
    params = dict(params, image_newline=torch.randn(
        d, generator=torch.Generator(device=dev).manual_seed(SEED + 5), device=dev,
        dtype=dtype) * 0.02)
    images = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for w, h in sz["images"]]
    vocab = cfg_sparse.text.vocab_size
    ids = [np.concatenate([rng.integers(3, vocab, 12), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, vocab, 4 + 8 * i)]) for i in range(2)]
    proc = ClipImagePreprocessor(size=vis.image_size)
    gc = GenerationConfig(max_new_tokens=HIRES_MAX_NEW, eos_token_id=-1)
    out = {"images": [list(s) for s in sz["images"]], "max_new_tokens": HIRES_MAX_NEW}
    pps = vis.num_patches_per_side

    # (a) the merged counts from the geometry alone, on the host
    want_counts = []
    for im in images:
        gw, gh = get_anyres_image_grid_shape(im.size, sz["pinpoints"], vis.image_size)
        zeros = np.zeros((gw * gh + 1, pps * pps, 1), np.float32)
        want_counts.append(merge_anyres_features(zeros, im.size, sz["pinpoints"],
                                                 vis.image_size, pps,
                                                 np.zeros(1, np.float32)).shape[0])
    arms = {}
    for arm, sparse in (("dense", DENSE_SPARSE_CONFIG), ("sparse", cfg_sparse.sparse)):
        cfg = dataclasses.replace(cfg_sparse, sparse=sparse, model_max_length=4096,
                                  image_aspect_ratio="anyres")
        gen = Generator(params, cfg, gc)
        r = {}
        sync()
        t0 = time.perf_counter()
        plan, feats, counts = gen.anyres_inputs(ids, images, sz["pinpoints"], proc)
        sync()
        r["encode_merge_ms"] = (time.perf_counter() - t0) * 1e3
        require(counts == want_counts, f"5h {arm} (a): merged counts {counts}, the host's "
                f"geometry gives {want_counts}")
        require(list(plan.valid_len) == [len(p) - 1 + n for p, n in zip(ids, counts)],
                f"5h {arm}: planned lengths {list(plan.valid_len)}")
        r["merged_tokens"], r["prompt_tokens"] = counts, [int(v) for v in plan.valid_len]
        t0 = time.perf_counter()
        tokens = gen.generate_anyres(ids, images, sz["pinpoints"], proc)
        sync()
        r["first_call_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = gen.generate_anyres(ids, images, sz["pinpoints"], proc)
        sync()
        r["call_s"] = time.perf_counter() - t0
        require(again == tokens, f"5h {arm}: a second call gave other tokens")
        prefill_ms = []
        with torch.inference_mode():
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                gen.prefill_anyres(plan, feats, HIRES_MAX_NEW)
                sync()
                prefill_ms.append((time.perf_counter() - t0) * 1e3)
        r["prefill_ms"] = statistics.median(prefill_ms[1:])
        steps = HIRES_MAX_NEW - 1
        logits, record = teacher_forced_logits(torch, params, cfg, gen, plan, feats, tokens,
                                               steps)
        if arm == "dense":  # (b)
            ref = nocache_logits(torch, params, cfg, gen, plan, feats, tokens,
                                 HIRES_CHECK_STEPS)
            err, bound = logits_hold(logits[:HIRES_CHECK_STEPS + 1], ref)
            r["nocache_max_abs_err"], r["nocache_bound"] = err, bound
            r["nocache_prefill_max_abs_err"] = float((logits[0] - ref[0]).abs().max())
            require(err <= bound, f"5h (b): the cached anyres path's logits leave the no-cache "
                    f"forward's by {err:.4f} (bound {bound:.4f})")
        # (c) each image alone at B=1
        alone = [gen.generate_anyres([ids[i]], [images[i]], sz["pinpoints"], proc)[0]
                 for i in range(2)]
        firsts = first_divergence(alone, tokens)
        found = explain_divergence(cfg, firsts, record, [[] for _ in range(2)])
        r["b1_equal"] = [f is None for f in firsts]
        r["b1_divergence"] = {str(i): v for i, v in found.items()}
        for i, v in found.items():
            require(v["stands"], f"5h {arm} (c): row {i} at B=2 leaves its B=1 tokens at "
                    f"{v['j']} without a near tie: {v}")
        r["tokens_b2"] = [t[:8] for t in tokens]
        arms[arm] = r
        log(f"  5h {arm}: merged {counts} image tokens, prompts {r['prompt_tokens']}; "
            f"encode + merge {r['encode_merge_ms']:.1f} ms, prefill {r['prefill_ms']:.1f} ms, "
            f"generate_anyres {r['first_call_s']:.2f} s first (capture), {r['call_s']:.2f} s "
            f"again; B=1 tokens equal {r['b1_equal']}"
            + (f"; no-cache hold {r['nocache_max_abs_err']:.4f} <= {r['nocache_bound']:.4f}"
               if arm == "dense" else ""))
        del gen
    out["arms"] = arms

    # (d) S2, (e) TokenPacker, on one preprocessed image
    frames = rng.integers(0, 256, (2, *sz["frame"], 3), dtype=np.uint8)
    t0 = time.perf_counter()
    pix = preprocess_batch(torch.from_numpy(frames).to(dev), out_size=vis.image_size)
    sync()
    out["preprocess_ms"] = (time.perf_counter() - t0) * 1e3
    errs = []
    for i in range(2):  # (f)
        ref = proc(expand2square(Image.fromarray(frames[i]), proc.background_color))
        e = np.abs(pix[i].cpu().numpy() - ref)
        errs.append((float(e.mean()), float(np.quantile(e, 0.99))))
    out["preprocess_err_mean_q99"] = errs
    require(all(m < 0.02 and q < 0.15 for m, q in errs),
            f"5h (f): preprocessing against PIL: {errs} (bounds 0.02 / 0.15)")
    with torch.inference_mode():
        x = pix[:1].to(dtype)
        t0 = time.perf_counter()
        s2 = towers.s2_tower_features(params["vision_tower"], vis, x, scales=sz["s2_scales"])
        sync()
        out["s2_ms"] = (time.perf_counter() - t0) * 1e3
        base = clip.vision_tower_features(params["vision_tower"], vis, x)
        out["s2_shape"] = list(s2.shape)
        out["s2_base_max_abs_err"] = float((s2[..., :vis.hidden_size] - base).abs().max())
        require(tuple(s2.shape) == (1, vis.num_patches, vis.hidden_size * len(sz["s2_scales"]))
                and bool(torch.isfinite(s2).all()), f"5h (d): S2 features {tuple(s2.shape)}")
        require(torch.equal(s2[..., :vis.hidden_size], base),
                f"5h (d): S2's first channel block leaves the tower's by "
                f"{out['s2_base_max_abs_err']:.3e}")
        tp = towers.init_tokenpacker_params(torch.Generator(device=dev).manual_seed(SEED + 6),
                                            kv_dim=vis.hidden_size,
                                            multi_dim=vis.hidden_size * len(sz["tp_layers"]),
                                            embed_dim=vis.hidden_size, hidden_size=d,
                                            num_heads=8, device=dev, dtype=dtype)
        t0 = time.perf_counter()
        single, multi = towers.tokenpacker_tower_features(params["vision_tower"], vis, x,
                                                          multi_layers=sz["tp_layers"])
        packed = towers.tokenpacker_project(tp, single, multi, raw_grid=pps, scale_factor=2)
        sync()
        out["tokenpacker_ms"] = (time.perf_counter() - t0) * 1e3
        out["tokenpacker_shape"] = list(packed.shape)
        require(tuple(packed.shape) == (1, (pps // 2) ** 2, d)
                and bool(torch.isfinite(packed).all()),
                f"5h (e): TokenPacker gave {tuple(packed.shape)}")
    out["wrapper_calls"] = {"flash_fwd": flash_attention.launches,
                            "decode_kernel": decode_attention.launches}
    require(not cuda or all(out["wrapper_calls"].values()),
            f"5h: a kernel never ran: {out['wrapper_calls']}")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  5h: S2 {out['s2_ms']:.1f} ms, TokenPacker {out['tokenpacker_ms']:.1f} ms, "
        f"preprocessing {out['preprocess_ms']:.1f} ms (PIL mean / q99 {errs}); wrapper calls "
        f"{out['wrapper_calls']}; peak {out['peak_gib']} GiB; {out['phase_s']:.1f} s")
    return out


def families(torch, device="cuda", sizes=None):
    """Phase 10: the other base families at 7B width on the first
    FAMILY_DEPTH of 32 layers, random bf16 weights from ``SEED``. Mistral-7B
    (hidden 4096, ffn 14336, GQA 32 / 8, window 4096), dense,
    ``model_max_length`` 8192: ``Generator.generate`` on text prompts of
    MISTRAL_PROMPTS tokens, FAMILY_MAX_NEW new tokens each (the first binds
    the window in prefill, the plain path, and in K2; the second runs K1 at
    GQA 32 / 8 inside it). Hold: the prefill's last logits and every decode
    step's (an eager loop along the graph's tokens) lie within
    ``logits_hold``'s bound of ``llama.forward_dense`` over prompt + tokens
    (the no-cache path with the window mask); control: without the window
    the rows past the window leave the windowed forward's by more than the
    bound. MPT-7B (d_model 4096, 32 heads, vocab 50368): one image + text
    prompt through ``mpt.forward_multimodal`` (the CLIP tower: K1), finite;
    ``mpt.generate_greedy`` FAMILY_MAX_NEW tokens on a text prompt, each
    the argmax of the teacher-forced ``mpt.forward_dense`` logits at its
    position or at a near tie (``near_tie_bound``). Then a tiny MPT
    checkpoint directory through ``load_pretrained_model``, which must give
    an ``MptRuntime`` with the saved weights. The K1 / K2 wrappers are
    zeroed at its start and read at its end (no trace); each must launch.
    ``device="cpu"`` with ``sizes`` (tiny ``mistral`` / ``mpt`` configs at
    their full depth, ``vision``, ``prompts``, ``image_prompt``: text tokens
    each side of the image) rehearses the phase on the plain versions.
    Returns the ``families`` record."""
    import json as _json
    import os
    import tempfile

    from dynamic_llava_tpu_torch.config import (
        DENSE_SPARSE_CONFIG, IMAGE_TOKEN_INDEX, ClipVisionConfig, LlamaConfig, LlavaConfig,
        MptConfig)
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.models import llama, mpt
    from dynamic_llava_tpu_torch.models.builder import MptRuntime, load_pretrained_model
    from dynamic_llava_tpu_torch.models.dynamic import decode_step
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
    from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention
    from dynamic_llava_tpu_torch.ops.flash_attention import flash_attention
    from dynamic_llava_tpu_torch.weights import init_llava_params, param_bytes

    sz = {**dict(mistral=dataclasses.replace(LlamaConfig.mistral_7b(),
                                             num_hidden_layers=FAMILY_DEPTH),
                 mpt=dataclasses.replace(MptConfig(), n_layers=FAMILY_DEPTH),
                 vision=ClipVisionConfig(), prompts=MISTRAL_PROMPTS, image_prompt=30),
          **(sizes or {})}
    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for fn in (flash_attention, decode_attention):
        fn.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    dtype = torch.bfloat16 if cuda else torch.float32
    rng = np.random.default_rng(SEED + 10)
    out = {}

    # Mistral-7B
    text = sz["mistral"]
    cfg = LlavaConfig(text=text, vision=sz["vision"], sparse=DENSE_SPARSE_CONFIG,
                      model_max_length=8192)
    params = init_llava_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 10), dev,
                               dtype)
    gen = Generator(params, cfg, GenerationConfig(max_new_tokens=FAMILY_MAX_NEW,
                                                  eos_token_id=-1))
    win = text.sliding_window
    out["depth"] = text.num_hidden_layers
    mistral = {}
    for n in sz["prompts"]:
        prompt = rng.integers(3, text.vocab_size, n)
        r = {"prompt_tokens": n}
        t0 = time.perf_counter()
        tokens = gen.generate([prompt])[0]
        sync()
        r["generate_s"] = time.perf_counter() - t0
        plan = plan_batch([prompt], 0, max_length=cfg.model_max_length,
                          pad_multiple=gen.gen_cfg.pad_multiple)
        steps = FAMILY_MAX_NEW - 1
        with torch.inference_mode():
            sync()
            t0 = time.perf_counter()
            state, _ = gen.prefill_from_plan(plan, None, FAMILY_MAX_NEW)
            sync()
            r["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            got = [state.last_logits.float()[0].clone()]
            for j in range(steps):
                state = decode_step(params, cfg, torch.tensor([tokens[j]], device=dev), state)
                got.append(state.last_logits.float()[0].clone())
            got = torch.stack(got)
            seq = torch.tensor(np.concatenate([prompt, tokens[:steps]])[None], device=dev)
            t0 = time.perf_counter()
            full = llama.forward_dense(params["llm"], text, seq)[0]
            sync()
            r["forward_dense_ms"] = (time.perf_counter() - t0) * 1e3
            err, bound = logits_hold(got, full[n - 1:])
            r["max_abs_err"], r["bound"] = err, bound
            r["greedy_equal"] = bool(torch.equal(torch.argmax(got, dim=-1).cpu(),
                                                 torch.tensor(tokens[:steps + 1])))
            require(err <= bound, f"10 Mistral {n}: cached logits leave forward_dense's by "
                    f"{err:.4f} (bound {bound:.4f})")
            if n > win:  # control: the window is live
                no_win = llama.forward_dense(
                    params["llm"], dataclasses.replace(text, sliding_window=None), seq)[0]
                gap = float((no_win[win:] - full[win:]).abs().max())
                r["unwindowed_rows_past_window_max_abs_diff"] = gap
                require(gap > bound, f"10 Mistral: without the window the rows past it "
                        f"differ by only {gap:.4f} (bound {bound:.4f})")
                del no_win
            del full, got, seq, state
        mistral[str(n)] = r
        log(f"  10 Mistral-7B {text.num_hidden_layers} layers, prompt {n}: generate {r['generate_s']:.2f} "
            f"s, prefill {r['prefill_ms']:.1f} ms, forward_dense {r['forward_dense_ms']:.1f} "
            f"ms; logits hold {err:.4f} <= {bound:.4f}; greedy equal {r['greedy_equal']}"
            + (f"; unwindowed past the window {r['unwindowed_rows_past_window_max_abs_diff']:.3f}"
               if n > win else ""))
    out["mistral"] = mistral
    out["mistral_params_gib"] = param_bytes(params["llm"]) / 2**30
    tower = {"vision_tower": params["vision_tower"], "mm_projector": params["mm_projector"]}
    del gen, params
    if cuda:
        torch.cuda.empty_cache()

    # MPT-7B
    mcfg = sz["mpt"]
    llm = mpt.init_mpt_params(torch.Generator(device=dev).manual_seed(SEED + 11), mcfg, dev,
                              dtype)
    vis = cfg.vision
    r = {"params_gib": param_bytes(llm) / 2**30}
    side = sz["image_prompt"]
    prompt = np.concatenate([rng.integers(3, mcfg.vocab_size, side), [IMAGE_TOKEN_INDEX],
                             rng.integers(3, mcfg.vocab_size, side)])
    plan = plan_batch([prompt], vis.num_patches)
    pix = torch.from_numpy(rng.standard_normal((1, vis.image_size, vis.image_size, 3),
                                               dtype=np.float32)).to(dev, dtype)
    with torch.inference_mode():
        t0 = time.perf_counter()
        mm = mpt.forward_multimodal(
            {"llm": llm, **tower}, mcfg, vis, *(torch.from_numpy(np.asarray(a)).to(dev) for a in
                                               (plan.token_ids, plan.is_image, plan.image_slot)),
            pix, valid_len=torch.from_numpy(plan.valid_len).to(dev))
        sync()
        r["forward_multimodal_ms"] = (time.perf_counter() - t0) * 1e3
        r["multimodal_shape"] = list(mm.shape)
        require(tuple(mm.shape) == (1, plan.seq_len, mcfg.vocab_size)
                and bool(torch.isfinite(mm).all()),
                f"10 MPT: forward_multimodal gave {tuple(mm.shape)}, or non-finite values")
        del mm
        text_prompt = torch.from_numpy(rng.integers(3, mcfg.vocab_size, (1, 64))).to(dev)
        t0 = time.perf_counter()
        toks = mpt.generate_greedy(llm, mcfg, text_prompt, FAMILY_MAX_NEW)[0]
        sync()
        r["generate_greedy_s"] = time.perf_counter() - t0
        seq = torch.cat([text_prompt[0], toks[:-1].to(text_prompt.dtype)])[None]
        ref = mpt.forward_dense(llm, mcfg, seq)[0, 63:]
        top2 = torch.topk(ref, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        tops = top2[:, 0].abs().cpu().numpy()
        same = (torch.argmax(ref, dim=-1) == toks).cpu().numpy()
    ties = [j for j in range(FAMILY_MAX_NEW) if not same[j]]
    r["argmax_equal"] = int(same.sum())
    r["near_ties"] = {str(j): dict(gap=float(gap[j]),
                                   bound=near_tie_bound(float(tops[j]), 2 * mcfg.n_layers + 1))
                      for j in ties}
    for j, v in r["near_ties"].items():
        require(v["gap"] < v["bound"], f"10 MPT: token {j} is not the teacher-forced argmax "
                f"and not at a near tie: {v}")
    out["mpt"] = r
    log(f"  10 MPT-7B {mcfg.n_layers} layers: forward_multimodal ({plan.seq_len} tokens) "
        f"{r['forward_multimodal_ms']:.1f} ms, generate_greedy {r['generate_greedy_s']:.2f} s; "
        f"{r['argmax_equal']} of {FAMILY_MAX_NEW} tokens the teacher-forced argmax, near ties "
        f"{r['near_ties']}")
    del llm, tower
    if cuda:
        torch.cuda.empty_cache()

    # the builder's MPT route, on a tiny checkpoint directory
    tiny = MptConfig.tiny()
    small = mpt.init_mpt_params(torch.Generator(device=dev).manual_seed(SEED + 12), tiny, dev)
    with tempfile.TemporaryDirectory() as d:
        torch.save({k: v.cpu() for k, v in mpt.mpt_state_dict(small).items()},
                   os.path.join(d, "pytorch_model.bin"))
        with open(os.path.join(d, "config.json"), "w") as f:
            _json.dump({"model_type": "mpt", "vocab_size": tiny.vocab_size,
                        "d_model": tiny.d_model, "n_heads": tiny.n_heads,
                        "n_layers": tiny.n_layers, "max_seq_len": tiny.max_seq_len}, f)
        _, runtime, _, ctx = load_pretrained_model(d, dtype=torch.float32, device=dev)
    require(isinstance(runtime, MptRuntime) and runtime.cfg == tiny and ctx == tiny.max_seq_len,
            f"10: the builder gave {type(runtime).__name__}")
    loaded = runtime.params["llm"]
    require(all(torch.equal(loaded["layers"][k], w) for k, w in small["layers"].items())
            and torch.equal(loaded["wte"], small["wte"]),
            "10: the loaded MPT weights are not the saved ones")
    out["builder_route"] = type(runtime).__name__
    out["wrapper_calls"] = {"flash_fwd": flash_attention.launches,
                            "decode_kernel": decode_attention.launches}
    require(not cuda or all(out["wrapper_calls"].values()),
            f"10: a kernel never ran: {out['wrapper_calls']}")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  10: builder route {out['builder_route']}; wrapper calls {out['wrapper_calls']}; "
        f"peak {out['peak_gib']} GiB; {out['phase_s']:.1f} s")
    return out


def main() -> int:
    if not (ROOT / "dynamic_llava_tpu_torch" / "csrc").is_dir():
        raise SystemExit(
            "chip_smoke.py: run it from a checkout of the repository "
            "(dynamic_llava_tpu_torch/ not found beside it)"
        )
    sys.path.insert(0, str(ROOT))
    use_kineto_config()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.config import (
        DENSE_SPARSE_CONFIG, LlamaConfig, LlavaConfig)
    from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention
    from dynamic_llava_tpu_torch.ops import quant_matmul as qm
    from dynamic_llava_tpu_torch.ops.flash_attention import flash_attention
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.ops.quant import (
        init_quantized_llama_params, quantize_llm_params)
    from dynamic_llava_tpu_torch.weights import init_llava_params, param_bytes

    phase("phase 2: build")
    t0 = time.perf_counter()
    # nvcc runs in processes of its own; meanwhile this thread does the
    # set-up that needs no kernel, each step timed apart
    built = {}

    def build():
        try:
            built["lib"] = kernels.load_library()
        except BaseException as e:  # raised again below, in this thread
            built["error"] = e

    builder = threading.Thread(target=build)
    builder.start()
    host_s = {}
    t1 = time.perf_counter()
    # the profiler's first start sets up CUPTI (seconds, once a process)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    host_s["the profiler's first start"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    try:  # phase 5e's and 9d's tokenizers
        from transformers import AutoTokenizer  # noqa: F401
        host_s["importing transformers"] = time.perf_counter() - t1
    except ImportError:
        log("  transformers does not import on this machine")
    t1 = time.perf_counter()
    from dynamic_llava_tpu_torch import native  # phase 9d's image ops
    native.load_image_ops()
    host_s["g++ of the native image ops"] = time.perf_counter() - t1
    builder.join()
    if "error" in built:
        raise built["error"]
    lib = built["lib"]
    log(f"  built {lib.path.name} in {lib.build_seconds:.1f} s "
        f"(load_library {time.perf_counter() - t0:.1f} s); meanwhile on the host: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in host_s.items()))
    entry, spilled = "", []
    for line in lib.ptxas_log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log(f"  {line.strip()}")
            if "Compiling" in line:
                entry = line.split("'")[1]
        elif "spill stores" in line:
            log(f"    {line.strip()}")
            if "0 bytes spill stores, 0 bytes spill loads" not in line:
                spilled.append(entry)
    # the tensor-core attention kernels, the decode-attention kernel and its
    # M-query form, the bf16 GEMV kernel and the fused MLP hold their
    # accumulators in registers
    no_spills = ("mma_kernel", "decode_kernel", "extend_kernel", "gemv_tc_kernel",
                 "q4_mlp_kernel")
    require(not [e for e in spilled if any(k in e for k in no_spills)],
            f"ptxas spilled registers in {spilled}")

    phase("phase 3: kernels against their plain versions")
    kres = check_kernels(torch)
    kres["decode_attention_appended"] = check_decode_kernel(torch)
    kres["extend_attention_appended"] = check_extend_kernel(torch)
    kres.update(check_train_kernels(torch))
    kres["flash_attention_fwd"]["train_shape"] = kres.pop("flash_attention_fwd_train_shape")
    kres.update(check_quant_kernels(torch))
    kres["q4_mlp"] = check_mlp_kernel(torch)
    check_tower_gradient(torch)

    phase("phase 4: small model, card against plain CPU path")
    check_small_model(torch)
    check_small_train(torch)

    phase("phase 4b: the quality gates on the card: vision, output text, train then evaluate "
          "(the JAX tests' configs, head_dim 16 zero-padded to 64, fp32)")
    quality = quality_gates(torch)

    counters = {"flash_attention_fwd": flash_attention,
                "decode_attention_appended": decode_attention,
                "q8_gemv": qm.q8_gemv, "q8_gemv_group": qm.q8_gemv_group,
                "q4_gemv": qm.q4_gemv, "q4_gemv_group": qm.q4_gemv_group,
                "q4_mlp": qm.q4_mlp}
    # the kernels each path must launch; the JSON line reports each
    # kernel's launches in the path named here
    paths = {"bf16": ("flash_attention_fwd", "decode_attention_appended"),
             "int8": ("q8_gemv", "q8_gemv_group"),
             "int4": ("q4_gemv", "q4_gemv_group", "q4_mlp"),
             "lean": ("q4_gemv", "q4_gemv_group", "q4_mlp"),
             "ring": ("q4_gemv", "q4_gemv_group", "q4_mlp"),
             "13b": ("q4_gemv", "q4_gemv_group", "q4_mlp")}
    # the JSON line reports a kernel's launches in the path named here
    reported = {"bf16": ("flash_attention_fwd", "decode_attention_appended"),
                "int8": ("q8_gemv", "q8_gemv_group"), "int4": ("q4_gemv", "q4_gemv_group"),
                "lean": ("q4_mlp",)}
    # a serving wrapper -> the kernel it launches (kernel_cases.SERVING_KERNELS);
    # a GEMV wrapper and its group form launch the same kernel
    kernel_of = {"flash_attention_fwd": "flash_fwd", "decode_attention_appended": "decode_kernel",
                 "q8_gemv": "gemv int8", "q8_gemv_group": "gemv int8",
                 "q4_gemv": "gemv int4", "q4_gemv_group": "gemv int4",
                 "q4_mlp": "q4_mlp_kernel"}
    launches, calls, results = {}, {}, {}

    def drive(label, params, modes, **kw):
        need = ("flash_attention_fwd", "decode_attention_appended") + paths[label]
        results[label] = serve(torch, params, modes, counters, need, label, **kw)
        runs = results[label].values()
        host = {n: sum(r["launches"][n] for r in runs) for n in counters}
        device = {k: sum(r["device_launches"][k] for r in runs) for k in set(kernel_of.values())}
        for n in reported.get(label, ()):
            launches[n], calls[n] = device[kernel_of[n]], host[n]
        log(f"  {label} path: wrapper calls {host}, launches on the card {device}")

    cfg_sparse = LlavaConfig()
    cfg_dense = LlavaConfig(sparse=DENSE_SPARSE_CONFIG)
    both = [("sparse", cfg_sparse), ("dense", cfg_dense)]
    dev = torch.device("cuda")

    phase("phase 5: LLaVA-1.5-7B width, random bf16 weights, sparse and dense")
    t0 = time.perf_counter()
    params = init_llava_params(
        cfg_sparse, torch.Generator(device=dev).manual_seed(SEED), dev, torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  params: {param_bytes(params) / 2**30:.2f} GiB "
        f"(decoder {param_bytes(params['llm']) / 2**30:.2f}) in "
        f"{time.perf_counter() - t0:.1f} s")
    drive("bf16", params, both)
    # K1 once a tower layer and decoder layer per prefill (two batches, sparse
    # and dense): the differentiable tower costs serving no launch
    vis = cfg_sparse.vision
    per_prefill = (vis.num_hidden_layers + vis.select_layer + 1
                   + cfg_sparse.text.num_hidden_layers)
    require(launches["flash_attention_fwd"] == calls["flash_attention_fwd"]
            == 2 * 2 * per_prefill,
            f"bf16 path: K1 launched {launches['flash_attention_fwd']} times "
            f"({calls['flash_attention_fwd']} wrapper calls), not {2 * 2 * per_prefill}")

    phase(f"phase 5b: multi-round chat at LLaVA-1.5-7B width through ChatSession.ask, the first "
          f"{CHAT_DEPTH} of the phase-5 decoder's 32 layers: sparse, dense, sparse with an int8 "
          "KV cache")
    chat_text = dataclasses.replace(cfg_sparse.text, num_hidden_layers=CHAT_DEPTH)
    chat_sparse = dataclasses.replace(cfg_sparse, text=chat_text)
    results["chat"] = chat(torch, {**params, "llm": first_layers(params["llm"], CHAT_DEPTH)}, [
        ("sparse", chat_sparse, {}),
        ("dense", dataclasses.replace(cfg_dense, text=chat_text), {}),
        ("sparse int8-KV", chat_sparse, dict(cache_dtype="int8")),
    ])

    def cut(cfg, depth):
        return dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=depth))

    def cut_params(depth):
        return {**params, "llm": first_layers(params["llm"], depth)}

    phase(f"phase 5c: speculative decoding and beam search at LLaVA-1.5-7B width, the first "
          f"{SPEC_DEPTH} of the phase-5 decoder's 32 layers: B=1 and 8, sparse and dense, "
          "k = 4 and 7")
    t5c = time.perf_counter()
    spec_sparse, spec_dense = cut(cfg_sparse, SPEC_DEPTH), cut(cfg_dense, SPEC_DEPTH)
    spec_params = cut_params(SPEC_DEPTH)
    spec = speculate(torch, spec_params, [("B=1 sparse", spec_sparse, 1),
                                          ("B=1 dense", spec_dense, 1),
                                          ("B=8 sparse", spec_sparse, 8),
                                          ("B=8 dense", spec_dense, 8)], "bf16")
    beam = beam_phase(torch, spec_params, spec_sparse)
    del spec_params
    log(f"  phase 5c bf16 arms and beam: {time.perf_counter() - t5c:.1f} s")

    phase(f"phase 5d: continuous batching at LLaVA-1.5-7B width, the first {CONT_DEPTH} of the "
          f"phase-5 decoder's 32 layers: {CONT_REQUESTS} requests every {CONT_ARRIVAL_S} s, "
          f"{CONT_SLOTS} slots; the engine, the window batcher, the engine with "
          f"spec_k={CONT_SPEC_K}")
    t5d = time.perf_counter()
    cont_sparse = cut(cfg_sparse, CONT_DEPTH)
    trace = continuous_trace(cont_sparse)
    spec_arm = f"engine spec k={CONT_SPEC_K}"
    cont = continuous(torch, cut_params(CONT_DEPTH), cont_sparse, [
        ("engine", "engine", {}),
        ("window", "window", {}),
        (spec_arm, "engine", dict(spec_k=CONT_SPEC_K)),
    ], trace, holds=[("engine", "window"), (spec_arm, "window"), (spec_arm, "engine")])
    log(f"  phase 5d bf16 arms: {time.perf_counter() - t5d:.1f} s")

    phase(f"phase 5e: checkpoint: the first {CKPT_DEPTH} of the phase-5 decoder's 32 layers "
          "exported, loaded back onto the card, and served through generate, the chat CLI's "
          "loop and the VQA CLI")
    t5e = time.perf_counter()

    def serve_http(path):
        phase("phase 5f: serving over HTTP at LLaVA-1.5-7B width on phase 5e's checkpoint: the "
              "controller, the model worker (plain, --spec-k), the batched worker (window, "
              "continuous)")
        served = serving(torch, path, ckpt_sparse)
        phase(f"phase 5g: the generation-quality probes at LLaVA-1.5-7B width, {CKPT_DEPTH} of "
              "32 layers, on phase 5e's checkpoint in fp32 (self-PPL, LVIS PPL sparse and dense, METEOR, "
              "multi-round, the keep mask), the bench core on the phase-5 weights")
        return served, ppl_tools(torch, path, ckpt_params, ckpt_sparse)

    # the checkpoint path on the first CKPT_DEPTH layers: phase 5's sparse
    # batch generated on those views is what the loaded checkpoint must give
    ckpt_sparse, ckpt_params = cut(cfg_sparse, CKPT_DEPTH), cut_params(CKPT_DEPTH)
    want = Generator(ckpt_params, ckpt_sparse, GenerationConfig(
        max_new_tokens=64, temperature=0.0, eos_token_id=-1)).generate(
        *serving_batch(ckpt_sparse, 8, 60))
    (served, (tools, core)), ckpt = checkpoint(
        torch, ckpt_params, ckpt_sparse, want, then=serve_http)
    del ckpt_params
    log(f"  phase 5e: {time.perf_counter() - t5e - served['phase_s'] - tools['phase_s']:.1f} s; "
        f"phase 5f: {served['phase_s']:.1f} s; phase 5g: {tools['phase_s']:.1f} s")

    phase("phase 5h: high resolution and the other towers at LLaVA-1.5-7B width, 32 layers, on "
          "the phase-5 weights: generate_anyres at B=2 (672x672, 1008x336) dense and sparse, "
          "S2, TokenPacker, on-device preprocessing")
    hires_r = hires(torch, params, cfg_sparse)

    phase(f"phase 6: quantized serving at 7B width, the first {QUANT_DEPTH} of 32 layers")
    t0 = time.perf_counter()
    quantize_llm_params(params, bits=8)
    torch.cuda.synchronize()
    log(f"  int8: decoder quantized in place in {time.perf_counter() - t0:.1f} s, "
        f"{param_bytes(params['llm']) / 2**30:.2f} GiB (all params "
        f"{param_bytes(params) / 2**30:.2f} GiB)")
    quant_both = [(mode, cut(cfg, QUANT_DEPTH)) for mode, cfg in both]
    drive("int8", cut_params(QUANT_DEPTH), quant_both)
    t0 = time.perf_counter()
    spec.update(speculate(torch, cut_params(SPEC_DEPTH), [("B=8 sparse", spec_sparse, 8)],
                          "int8", gemv_kernel="gemv int8"))
    log(f"  phase 5c int8 arm: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fp8_kv = dict(cache_dtype="float8_e4m3fn")
    cont.update(continuous(torch, cut_params(CONT_DEPTH), cont_sparse, [
        ("engine int8 fp8-KV", "engine", dict(gen=fp8_kv, int8=True)),
        ("window int8 fp8-KV", "window", dict(gen=fp8_kv)),
    ], trace, holds=[("engine int8 fp8-KV", "window int8 fp8-KV")]))
    log(f"  phase 5d int8 fp8-KV arms: {time.perf_counter() - t0:.1f} s")
    # the engines' launches on the card (their traced passes) join each
    # kernel's count
    engines = [r for r in cont.values() if r["kind"] == "engine"]
    for name, label in (("flash_attention_fwd", "flash_fwd"),
                        ("decode_attention_appended", "decode_kernel")):
        launches[name] += sum(r["device_launches"][label] for r in engines)
        calls[name] += sum(r["wrapper_calls"][label] for r in engines)
    for name in ("q8_gemv", "q8_gemv_group"):
        launches[name] += sum(r["device_launches"]["gemv int8"] for r in engines)
    # phase 5e's path (generate, the chat loop and the VQA CLI on the loaded weights)
    for name, label in (("flash_attention_fwd", "flash_fwd"),
                        ("decode_attention_appended", "decode_kernel")):
        launches[name] += ckpt["device_launches"][label]
        calls[name] += ckpt["wrapper_calls"][label]
    # K2-M's main paths: the chat's continuations and the traced speculative
    # generations
    traced = [r["k"][SPEC_KS[-1]] for r in spec.values()]
    by_path = {"chat": sum(r["device_launches"]["extend_kernel"]
                           for r in results["chat"].values()),
               "speculative": sum(t["device_launches"]["extend_kernel"] for t in traced),
               "continuous": sum(r["device_launches"]["extend_kernel"] for r in engines),
               "checkpoint": ckpt["device_launches"]["extend_kernel"]}
    kres["extend_attention_appended"]["launches_by_path"] = by_path
    launches["extend_attention_appended"] = sum(by_path.values())
    calls["extend_attention_appended"] = sum(
        r["launches"]["extend_kernel"] for r in results["chat"].values()) + sum(
        t["launches"]["extend_kernel"] for t in traced) + sum(
        r["wrapper_calls"]["extend_kernel"] for r in engines) + ckpt["wrapper_calls"][
        "extend_kernel"]
    # phase 5f's, 5g's and 5h's wrapper calls (they take no trace: their graph
    # replays are not counted)
    for name, label in (("flash_attention_fwd", "flash_fwd"),
                        ("decode_attention_appended", "decode_kernel"),
                        ("extend_attention_appended", "extend_kernel")):
        calls[name] += (served["wrapper_calls"][label] + tools["wrapper_calls"][label]
                        + hires_r["wrapper_calls"].get(label, 0))
    del params["llm"]
    torch.cuda.empty_cache()
    params["llm"] = init_quantized_llama_params(
        cfg_sparse.text, torch.Generator(device=dev).manual_seed(SEED), dev, bits=4)
    torch.cuda.synchronize()
    log(f"  int4: decoder made directly, {param_bytes(params['llm']) / 2**30:.2f} GiB "
        f"(all params {param_bytes(params) / 2**30:.2f} GiB)")
    drive("int4", cut_params(QUANT_DEPTH), quant_both[:1])

    phase(f"phase 7: lean-memory serving at 7B width on the first {LEAN_DEPTH} of the int4 "
          "decoder's 32 layers: the fused MLP (K9) off and on, int8 and fp8 KV caches, ring "
          "overflow; the KV cosine on all 32")
    full_llm = params["llm"]
    params["llm"] = first_layers(full_llm, LEAN_DEPTH)
    lean_text = dataclasses.replace(cfg_sparse.text, num_hidden_layers=LEAN_DEPTH)
    lean_sparse = dataclasses.replace(cfg_sparse, text=lean_text)
    lean_dense = dataclasses.replace(cfg_dense, text=lean_text)
    int8kv, fp8kv = dict(cache_dtype="int8"), dict(cache_dtype="float8_e4m3fn")
    # two-kernel, fused, fused, two-kernel: the host's pace drifts within a call
    drive("lean", params, [
        ("sparse bf16-KV two-kernel MLP", lean_sparse),
        ("sparse bf16-KV fused MLP", lean_sparse, dict(fused=True)),
        ("sparse bf16-KV fused MLP, again", lean_sparse, dict(fused=True)),
        ("sparse bf16-KV two-kernel MLP, again", lean_sparse),
        ("sparse int8-KV fused MLP", lean_sparse, dict(fused=True, gen=int8kv)),
        ("dense int8-KV fused MLP", lean_dense, dict(fused=True, gen=int8kv)),
        ("sparse fp8-KV fused MLP", lean_sparse, dict(fused=True, gen=fp8kv)),
    ])
    # 256 new tokens at a decode window of 64: both tiers wrap
    ring = dict(cache_dtype="int8", kv_overflow="ring", kv_window=64)
    drive("ring", params, [("sparse int8-KV fused MLP, 256 new tokens", lean_sparse,
                            dict(fused=True, gen=ring))], max_new=256)
    params["llm"] = full_llm
    del full_llm
    cosine = kv_cosine(torch, params, cfg_sparse)
    del params["llm"]
    torch.cuda.empty_cache()

    phase(f"phase 8: LLaVA-1.5-13B width (hidden 5120, ffn 13824), the first {DEPTH_13B} of its "
          "40 layers, int4 decoder made directly, fused MLP, B=1, 256 new tokens")
    text13 = dataclasses.replace(LlamaConfig.llama_13b(), num_hidden_layers=DEPTH_13B)
    cfg13 = LlavaConfig(text=text13)
    # tower, projector and predictors at the 13B decoder's width, without a
    # bf16 decoder (26 GB that the int4 path never holds)
    params = init_llava_params(
        dataclasses.replace(cfg13, text=dataclasses.replace(text13, num_hidden_layers=0)),
        torch.Generator(device=dev).manual_seed(SEED + 2), dev, torch.bfloat16)
    params["llm"] = init_quantized_llama_params(
        text13, torch.Generator(device=dev).manual_seed(SEED + 2), dev, bits=4)
    torch.cuda.synchronize()
    log(f"  13B int4: decoder {param_bytes(params['llm']) / 2**30:.2f} GiB (all params "
        f"{param_bytes(params) / 2**30:.2f} GiB)")
    drive("13b", params, [
        ("sparse", cfg13, dict(fused=True)),
        ("dense", LlavaConfig(text=text13, sparse=DENSE_SPARSE_CONFIG), dict(fused=True)),
    ], b=1, max_new=256)
    del params
    torch.cuda.empty_cache()

    phase(f"phase 9: training at LLaVA-1.5-7B width, {TRAIN_DEPTH} decoder layers, "
        "sparse steps, then dense-stage steps on the same weights")
    depth = TRAIN_DEPTH
    train_sparse = dataclasses.replace(
        cfg_sparse, text=dataclasses.replace(cfg_sparse.text, num_hidden_layers=depth))
    train_dense = dataclasses.replace(train_sparse, sparse=DENSE_SPARSE_CONFIG)
    params = init_llava_params(
        train_sparse, torch.Generator(device=dev).manual_seed(SEED + 1), dev, torch.bfloat16)
    expect = train_launches(train_sparse)
    results["train"] = {
        "sparse": train(torch, params, train_sparse, "train sparse", expect["sparse"]),
        "dense": train(torch, params, train_dense, "train dense", expect["dense"]),
    }
    # K3 and K4 report their launches on the sparse path, where all three run
    # (eager: one launch a wrapper call)
    for n in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv", "flash_policy_attention_fwd"):
        launches[n] = calls[n] = results["train"]["sparse"]["launches"][n]
    # phase 9d's final save holds the params and two moments of (most of) them
    cli_need = 3 * param_bytes(params)
    del params
    torch.cuda.empty_cache()

    phase(f"phase 9b: the remat policies {', '.join(REMAT_POLICIES)} at LLaVA-1.5-7B width, "
          f"sparse steps, each at the largest depth of {REMAT_DEPTHS} that fits")
    t0 = time.perf_counter()
    remat = remat_policies(torch, cfg_sparse)
    log(f"  phase 9b: {time.perf_counter() - t0:.1f} s")
    phase(f"phase 9c: QLoRA at LLaVA-1.5-7B width: int4 decoder, rank-{LORA_RANK} adapters "
          "on all seven targets, lora_mode")
    t0 = time.perf_counter()
    qlora_r = qlora(torch, cfg_sparse)
    log(f"  phase 9c: {time.perf_counter() - t0:.1f} s")
    phase(f"phase 9d: the training CLI (train_sparse) at LLaVA-1.5-7B width, 32 layers, bf16: "
          f"{CLI_STEPS} sparse steps over a JSON set, then its final save")
    t0 = time.perf_counter()
    cli = train_cli(torch, expect["sparse"], cli_need)
    cli["phase_s"] = time.perf_counter() - t0
    log(f"  phase 9d: {cli['phase_s']:.1f} s")
    # the CLI's launches (eager: one a wrapper call) join K1's, K3's and K4's
    for n in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
              "flash_policy_attention_fwd"):
        launches[n] += cli["launches"][n]
        calls[n] += cli["launches"][n]
    torch.cuda.empty_cache()

    phase(f"phase 10: the other families at 7B width, the first {FAMILY_DEPTH} of 32 layers, "
          f"random bf16 weights: Mistral-7B dense (prompts {MISTRAL_PROMPTS}, window 4096), "
          "MPT-7B (forward_multimodal, generate_greedy), the builder's MPT route")
    fam = families(torch)
    for name, label in (("flash_attention_fwd", "flash_fwd"),
                        ("decode_attention_appended", "decode_kernel")):
        calls[name] += fam["wrapper_calls"][label]
    require("jax" not in sys.modules and "dynamic_llava_tpu" not in sys.modules,
            "jax or the JAX package was imported")
    for label, runs in results.items():
        for mode, r in runs.items():
            if label == "chat":
                log(f"  summary chat {mode}: round-1 TTFT {r['ttft_ms']:.1f} ms, continuation "
                    f"{' / '.join(f'{ms:.1f}' for ms in r['continue_ms'])} ms "
                    f"({' / '.join(map(str, r['chunks']))} tokens), decode "
                    f"{r['decode_tok_s']:.1f} tok/s at B=1, peak {r['peak_gib']:.2f} GiB")
                continue
            if label == "train":
                log(f"  summary train {mode}: depth {r['depth']}, {r['step_ms']:.1f} ms/step, "
                    f"{r['tok_s']:.1f} tok/s, peak {r['peak_gib']:.2f} GiB")
                continue
            log(f"  summary {label} {mode}: TTFT {r['ttft_ms']:.1f} ms, decode "
                f"{r['decode_tok_s']:.1f} tok/s, peak {r['peak_gib']:.2f} GiB, KV cache "
                f"{r['kv_gib']:.3f} GiB")

    for name in ("q8_gemv", "q8_gemv_group", "q4_gemv", "q4_gemv_group"):
        r = kres[name]
        log(f"  {name}: max_abs_err {r['max_abs_err']:.3e}, max err / max|ref| "
            f"{r['max_err_rel']:.3e} over all shapes and rows; kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms at {r['shape']}")
    csrc = "dynamic_llava_tpu_torch/csrc/"
    table = {
        "flash_attention_fwd": (csrc + "flash_attention_fwd.cu",
                                "dynamic_llava_tpu/ops/flash_attention.py:38"),
        "decode_attention_appended": (csrc + "decode_attention.cu",
                                      "dynamic_llava_tpu/ops/decode_attention.py:29"),
        "extend_attention_appended": (csrc + "extend_attention.cu",
                                      "dynamic_llava_tpu/ops/attention.py:304"),
        "flash_attention_bwd_dkv": (csrc + "flash_attention_bwd.cu",
                                    "dynamic_llava_tpu/ops/flash_attention.py:303"),
        "flash_attention_bwd_dq": (csrc + "flash_attention_bwd.cu",
                                   "dynamic_llava_tpu/ops/flash_attention.py:365"),
        "flash_policy_attention_fwd": (csrc + "flash_policy_fwd.cu",
                                       "dynamic_llava_tpu/ops/flash_policy.py:34"),
        "q8_gemv": (csrc + "quant_gemv.cu", "dynamic_llava_tpu/ops/quant_matmul.py:226"),
        "q8_gemv_group": (csrc + "quant_gemv.cu",
                          "dynamic_llava_tpu/ops/quant_matmul.py:376"),
        "q4_gemv": (csrc + "quant_gemv.cu", "dynamic_llava_tpu/ops/quant_matmul.py:46"),
        "q4_gemv_group": (csrc + "quant_gemv.cu",
                          "dynamic_llava_tpu/ops/quant_matmul.py:538"),
        "q4_mlp": (csrc + "quant_mlp.cu", "dynamic_llava_tpu/ops/quant_matmul.py:706"),
    }
    # beside the required keys: K2's int8 and fp8 storage readings and its
    # other shapes, every GEMV shape's readings by rows, K9's
    # two-kernel time (K8 + silu*mul + K7) and 13B-shape readings, K1's CLIP
    # shape and full-length readings, K3's delta kernel and whole backward
    extra = {"decode_attention_appended": ("int8", "fp8", "shapes"),
             "extend_attention_appended": ("int8", "fp8", "shapes", "cache_reads",
                                           "launches_by_path"),
             "q8_gemv": ("shapes",), "q8_gemv_group": ("shapes",),
             "q4_gemv": ("shapes",), "q4_gemv_group": ("shapes",),
             "q4_mlp": ("two_kernel_ms", "shapes"),
             "flash_policy_attention_fwd": ("vsum_ms", "main_ms", "sdpa_log_policy_mask_ms",
                                            "bf16_rounding_err", "launches_per_step_by_policy"),
             "flash_attention_fwd": ("full_length_ms", "library_full_length_ms", "clip", "shapes",
                                     "train_shape", "launches_per_step_by_policy"),
             "flash_attention_bwd_dq": ("delta_ms", "delta_plain_ms", "delta_bound_ms",
                                        "delta_library_ms", "delta_max_abs_err",
                                        "whole_backward_ms")}
    # the launches of a GEMV wrapper and its group form are one kernel's
    shared = {"q8_gemv": "q8_gemv_group", "q8_gemv_group": "q8_gemv",
              "q4_gemv": "q4_gemv_group", "q4_gemv_group": "q4_gemv"}
    # F2: what a training step launches under each remat policy
    for name in ("flash_attention_fwd", "flash_policy_attention_fwd"):
        kres[name]["launches_per_step_by_policy"] = {
            policy: r["launches_per_step"][name] for policy, r in remat.items()}
    phase("  all phases done")
    print("decode_graph " + json.dumps({
        f"{label} {mode}": r["graph"] for label, runs in results.items()
        if label not in ("train", "chat") for mode, r in runs.items()}))
    print("spec " + json.dumps({"arms": {
        arm: {key: (v if key != "k" else {
            k: {f: x for f, x in kr.items() if f not in ("device_launches", "launches")}
            for k, kr in v.items()}) for key, v in r.items()}
        for arm, r in spec.items()}, "beam": beam}))
    print("chat " + json.dumps({
        mode: {k: r[k] for k in ("ttft_ms", "continue_ms", "chunks", "decode_tok_s",
                                 "round_decode_tok_s", "capture_ms", "peak_gib", "steps")}
        for mode, r in results["chat"].items()}))
    print("quality " + json.dumps(quality))
    print("kv_cosine " + json.dumps(cosine))
    print("remat " + json.dumps({
        policy: {k: r[k] for k in ("depth", "first_step_s", "step_ms", "tok_s", "peak_gib",
                                   "launches_per_step", "decoder_k1_launches_per_step",
                                   "clip_k1_launches_per_step", "grad_max_rel_diff")}
        for policy, r in remat.items()}))
    print("qlora " + json.dumps(qlora_r))
    print("checkpoint " + json.dumps(ckpt))
    print("train_cli " + json.dumps(cli))
    print("serving " + json.dumps(served))
    print("ppl_tools " + json.dumps(tools))
    print("bench_core " + json.dumps(core))
    print("hires " + json.dumps(hires_r))
    print("families " + json.dumps(fam))
    print("continuous " + json.dumps({
        arm: {k: v for k, v in r.items() if k not in ("device_launches", "wrapper_calls")}
        for arm, r in cont.items()}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": kres[name]["max_abs_err"],
         "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"],
         "bound_ms": kres[name]["bound_ms"], "bound_by": kres[name]["bound_by"],
         "library_ms": kres[name]["library_ms"], "wrapper_calls": calls[name],
         **({"launches_shared_with": shared[name]} if name in shared else {}),
         **{k: kres[name][k] for k in extra.get(name, ())}}
        for name, (source, replaces) in table.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
