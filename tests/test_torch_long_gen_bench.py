"""The bench's configurations and weights, and ``tools/long_gen_bench.py``,
against the JAX package and the root ``bench.py`` / ``run/long_gen_bench.py``
on the CPU.

``eval.bench.bench_cfg`` equals ``bench._cfg`` for the four names;
``build_bench_params``' leaves have the JAX tree's names, shapes and dtypes
bf16, int8 and int4 at ``small`` (but the int8 / int4 embedding scale,
whose JAX shape ``[1, D]`` is a recorded fault of the JAX init). The tool's
ring and drop modes at ``small``, 24 new tokens, window 8 (the ring wraps),
fp32 weights and cache, the same numbers in both packages: the greedy
tokens, both capacities and ``post_len_after_decode`` equal the JAX
harness's own computation (``make_gen_cache`` -> ``prefill(ring_mode=)``
-> a scan of ``decode_step``) exactly. The CLI at ``--model small --cpu``
returns 0, its ``LONGGEN_RESULT`` records have the JAX child's keys (less
``programs_gb``) and its last line the JAX summary's keys.

The helpers here serve the other harness test files: ``shared_weights``
(one fp32 tree in both packages), ``literal_dict_keys`` (the key sets of a
JAX script's dict displays), ``run_main`` (a tool's ``main`` in this
process, its children too: ``children_in_process``), ``one_thread`` and
``one_prefill_rep``.
The subprocess path of the children is held by
``tests/test_torch_serve_ladder.py``'s ladder CLI, which runs real ones.
"""

import ast
import contextlib
import functools
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.eval import bench as jbench
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu_torch.eval import bench as tbench
from dynamic_llava_tpu_torch.weights import init_llava_params, params_to_numpy

from test_torch_config import port_config

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import bench as root_bench  # noqa: E402  (the root bench.py)
import long_gen_bench  # noqa: E402

BATCH, TEXT, NEW, WINDOW = 2, 16, 24, 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops on one torch thread: under the suite's workers, threads
    only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_prefill_rep(monkeypatch):
    """The bench core times one prefill, not ten: the tests that take this
    read its keys and holds, not its times."""
    for name in ("bench_config", "bench_spec_config"):
        monkeypatch.setattr(tbench, name,
                            functools.partial(getattr(tbench, name), prefill_reps=1))


def shared_weights(cfg, seed=0):
    """Random fp32 params of ``cfg`` (the port's config): the port's tree on
    the CPU and the same numbers as the JAX package's tree."""
    tp = init_llava_params(cfg, torch.Generator().manual_seed(seed), "cpu", torch.float32)
    return jax.tree.map(jnp.asarray, params_to_numpy(tp)), tp


def literal_dict_keys(path, function):
    """The key sets of the dict displays in ``function`` of the script at
    ``path`` (string keys only; a ``**`` entry adds none)."""
    tree = ast.parse(Path(path).read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    return [frozenset(k.value for k in d.keys if isinstance(k, ast.Constant))
            for d in ast.walk(fn) if isinstance(d, ast.Dict)]


def children_in_process(monkeypatch, module):
    """``module``'s children run by its own ``main`` in this process (their
    flags as the parent builds them; their stdout read for the tag)."""
    def run(argv, tag, timeout):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert module.main([str(a) for a in argv[1:]]) == 0
        (line,) = [x for x in out.getvalue().splitlines() if x.startswith(tag + " ")]
        return json.loads(line[len(tag) + 1:])

    monkeypatch.setattr(module.harness, "run_child", run)


def run_main(capsys, module, *argv):
    """``module.main(argv)`` in this process: it returns 0; its stdout lines."""
    capsys.readouterr()
    assert module.main(list(argv)) == 0
    return capsys.readouterr().out.strip().splitlines()


@pytest.fixture(scope="module")
def weights():
    return shared_weights(tbench.bench_cfg("small"))


@pytest.mark.parametrize("name", ["7b", "13b", "1b", "small"])
def test_bench_cfg_matches_the_root_bench(name):
    assert tbench.bench_cfg(name) == port_config(root_bench._cfg(name))


def leaves(tree, prefix=""):
    """``{path: (shape, dtype name)}`` of a JAX or port param tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in leaves(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in leaves(sub, f"{prefix}/{i}").items()}
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_build_bench_params_structure_matches_the_root_bench(quant):
    cfg = root_bench._cfg("small")
    want = leaves(jax.eval_shape(lambda: root_bench.build_bench_params(cfg, quant)))
    got = leaves(tbench.build_bench_params(port_config(cfg), quant, "cpu"))
    if quant is not None:  # the JAX embedding scale is [1, D], the port's [V, 1]
        d, v = cfg.text.hidden_size, cfg.text.vocab_size
        assert want.pop("/llm/embed/s") == ((1, d), "bfloat16")
        assert got.pop("/llm/embed/s") == ((v, 1), "bfloat16")
    assert got == want
    assert all(dt == "bfloat16" for k, (_, dt) in got.items() if not k.startswith("/llm/"))


def test_build_bench_params_is_seeded_and_rejects_other_quants():
    cfg = tbench.bench_cfg("small")
    a, b = (tbench.build_bench_params(cfg, "int8", "cpu", seed=s) for s in (0, 0))
    c = tbench.build_bench_params(cfg, "int8", "cpu", seed=1)
    assert torch.equal(a["llm"]["layers"]["q"]["q"], b["llm"]["layers"]["q"]["q"])
    assert not torch.equal(a["llm"]["layers"]["q"]["q"], c["llm"]["layers"]["q"]["q"])
    with pytest.raises(ValueError, match="quant"):
        tbench.build_bench_params(cfg, "int3", "cpu")


def jax_long_gen(jp, cfg, mode):
    """The JAX harness's computation (``run/long_gen_bench.py`` ``measure``)
    with an fp32 cache: (tokens ``[new, B]``, capacities, post length)."""
    ring = mode == "ring"
    plan, imgs = jbench.build_inputs(cfg, BATCH, TEXT)
    cache = jdyn.make_gen_cache(cfg, plan.batch, plan.seq_len, NEW, jnp.float32,
                                all_have_image=True, decode_window=WINDOW if ring else None,
                                ring=ring)
    plan_args = tuple(jnp.asarray(a) for a in (
        plan.token_ids, plan.is_image, plan.image_slot, plan.valid_len, plan.spans.image_start,
        plan.spans.last_instruct_start, plan.spans.last_instruct_end, plan.spans.has_image))

    @jax.jit
    def run(params, cache, *a):
        state, _ = jdyn.prefill(params, cfg, *a[:-1], a[-1], cache, all_have_image=True,
                                ring_mode=ring)

        def body(state, _):
            tok = jnp.argmax(state.last_logits, axis=-1)
            return jdyn.decode_step(params, cfg, tok, state,
                                    kv_overflow="ring" if ring else "drop"), tok

        return jax.lax.scan(body, state, None, length=NEW)

    state, toks = run(jp, cache, *plan_args, jnp.asarray(imgs, jnp.bfloat16))
    return (np.asarray(toks), (int(state.cache.pre.max_len), int(state.cache.post.max_len)),
            float(np.mean(np.asarray(state.cache.post.length))))


def tool_args(mode):
    return long_gen_bench.parser().parse_args([
        "--model", "small", "--cpu", "--mode", mode, "--batch", str(BATCH), "--text", str(TEXT),
        "--new", str(NEW), "--window", str(WINDOW), "--cache-dtype", "float32"])


@pytest.mark.parametrize("mode", ["ring", "drop"])
def test_long_gen_modes_equal_the_jax_harness(weights, mode):
    jp, tp = weights
    want_toks, want_caps, want_post = jax_long_gen(jp, root_bench._cfg("small"), mode)
    tokens = []
    got = long_gen_bench.measure(tool_args(mode), tp, tokens=tokens)
    assert tokens == [[int(t) for t in want_toks[:, i]] for i in range(BATCH)]
    assert (got["pre_cache_capacity"], got["post_cache_capacity"]) == want_caps
    assert got["post_len_after_decode"] == want_post
    # ring: both tiers' decode regions capped at the window (the pre tier's
    # wraps at 24 tokens); drop: room for every new token
    cfg = tbench.bench_cfg("small")
    seq = tbench.build_inputs(cfg, BATCH, TEXT)[0].seq_len
    assert got["pre_cache_capacity"] == seq + (WINDOW if mode == "ring" else NEW) + 8
    assert got["decode_tok_s"] > 0 and got["live_after_decode_gb"] > 0


def test_long_gen_cli_prints_the_jax_keys(monkeypatch, capsys):
    children_in_process(monkeypatch, long_gen_bench)
    lines = run_main(capsys, long_gen_bench, "--model", "small", "--cpu", "--layers", "3",
                     "--batch", "1", "--text", "12", "--new", "10", "--window", "4",
                     "--quant", "none")
    results = [json.loads(line) for line in lines[:-1]]
    assert [list(r) for r in results] == [["ring"], ["drop"]]
    jax_script = ROOT / "run" / "long_gen_bench.py"
    # the JAX child's keys: its literal ones and memory_report's (on the CPU)
    child = {"live_bytes_gb", "model_bytes_gb", "non_model_live_gb", "peak_est_gb"} | max(
        literal_dict_keys(jax_script, "measure"), key=len)
    for r in results:
        (rec,) = r.values()
        assert set(rec) == child
    summary = json.loads(lines[-1])
    assert frozenset(summary) in literal_dict_keys(jax_script, "main")
    assert summary["metric"] == "longgen_small_b1_n10_w4"
    assert summary["pre_capacity_ring"] < summary["pre_capacity_drop"]
    assert summary["detail"] == {"ring": results[0]["ring"], "drop": results[1]["drop"]}
