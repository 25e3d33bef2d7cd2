"""``tools/serve_bench.py`` and ``tools/ladder_probe.py`` against
``run/serve_bench.py`` and ``run/ladder_probe.py`` on the CPU, and
``chip_smoke.harnesses`` (phase 5j) rehearsed on the CPU.

Serve: ``make_tokenizer`` encodes and decodes like the JAX script's; the
steady state counts the tokens after the first chunk up to the last chunk
that added any; the CLI prints the JAX script's keys (phase 5j holds the
worker's stream). Ladder: ``CACHE_DTYPES`` and ``parse_row`` as JAX's;
the default rows are the measured fit and first failure of the JAX plan's
three compositions, and ``kv_bytes_per_sample`` (phase 5j's out-of-memory
batch) is ``make_gen_cache``'s bytes; the probe records a failing child as
``error`` (its output's tail), a row past ``--budget-s`` as ``skipped``
(also one that the closing budget cut), and goes on; the CLI with a
failing and a good row, each a real child process, prints ``LADDER_ROW``
lines and ``{"ladder_probe": [...]}`` last.

Phase 5j: the five tools' ``measure`` at the small model's size (3
layers, fp32), a failing ladder row in a real child in place of the card's
out-of-memory row. Its holds pass (speculative tokens equal plain
greedy's, both long-generation modes' capacities equal
``gen_cache_sizes``', the worker's streamed text, tokenized, is
``Generator.generate``'s greedy tokens up to EOS but the unknown token,
which decodes to nothing; the failing row recorded and the next one
measured), and its record carries every tool's
summary; on the CPU no wrapper counts a launch.
"""

import importlib.util
import json
import os
import subprocess
import sys

import torch

from dynamic_llava_tpu_torch.eval.bench import bench_cfg, build_inputs, dense_config
from dynamic_llava_tpu_torch.models.dynamic import make_gen_cache
from dynamic_llava_tpu_torch.weights import init_llava_params

from test_torch_long_gen_bench import (  # noqa: F401  (one_thread, one_prefill_rep: fixtures)
    ROOT, literal_dict_keys, one_prefill_rep, one_thread, run_main)

import chip_smoke
import ladder_probe
import serve_bench

# the CLI's children: one torch thread each beside the suite's workers
CHILD_ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))


def jax_script(name):
    """A root ``run/`` script as a module of its own name."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "run" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_tokenizer_encodes_like_the_jax_script():
    want, got = (m.make_tokenizer(300) for m in (jax_script("serve_bench"), serve_bench))
    text = "t5 t299 t2 </s> t300 words <unk> t17"
    assert got(text).input_ids == want(text).input_ids
    ids = [5, 0, 1, 299, 17]
    assert got.decode(ids, skip_special_tokens=True) == want.decode(ids,
                                                                    skip_special_tokens=True)
    assert (got.eos_token_id, got.unk_token_id, got.model_max_length) == (1, 0, 2048)


def test_serve_steady_state_counts_only_chunks_that_add_tokens(monkeypatch):
    """Chunks of 3, 6 and 8 tokens at 10, 12 and 13 s, then the final chunk
    repeating the text at 20 s: TTFT 10 s, steady state the 5 tokens after
    the first chunk over 13 - 10 s (the JAX formula: (8 - 8 // 4) / 10)."""
    from dynamic_llava_tpu_torch.eval import bench as tbench
    from dynamic_llava_tpu_torch.serve import model_worker

    prompt = " ".join(f"t{100 + i}" for i in range(4))
    words = [f"t{200 + i}" for i in range(8)]
    texts = [prompt + " " + " ".join(words[:n]) for n in (3, 6, 8, 8)]

    class Worker:
        def __init__(self, *a, **k):
            pass

        def generate_stream(self, req):
            for t in texts:
                yield json.dumps({"text": t, "error_code": 0}).encode() + b"\0"

        def close(self):
            pass

    clock = iter([0.0, 10.0, 12.0, 13.0, 20.0])  # the request, then each chunk
    monkeypatch.setattr(model_worker, "ModelWorker", Worker)
    monkeypatch.setattr(serve_bench.time, "time", lambda: next(clock))
    monkeypatch.setattr(tbench, "bench_config", lambda *a, **k: {"decode_tok_s": 2.5})
    args = serve_bench.parser().parse_args(["--model", "small", "--cpu", "--text-len", "4"])
    got = serve_bench.measure(args, params={})
    assert got == {"model": "small", "worker_decode_tok_s": round(5 / 3, 2),
                   "worker_ttft_s": 10.0, "worker_tokens": 8, "raw_decode_tok_s": 2.5,
                   "worker_vs_raw": round(5 / 3 / 2.5, 4)}


def test_serve_cli_prints_the_jax_keys(capsys, one_prefill_rep):
    lines = run_main(capsys, serve_bench, "--model", "small", "--cpu", "--layers", "3",
                     "--new-tokens", "6", "--text-len", "12")
    got = json.loads(lines[-1])
    assert frozenset(got) in literal_dict_keys(ROOT / "run" / "serve_bench.py", "main")
    assert got["model"] == "small" and got["raw_decode_tok_s"] > 0


def test_rows_parse_as_the_jax_script_parses_them():
    jax_ladder = jax_script("ladder_probe")
    assert ladder_probe.CACHE_DTYPES == jax_ladder.CACHE_DTYPES
    for s in ladder_probe.DEFAULT_ROWS + jax_ladder.DEFAULT_ROWS + ["dense:-:bf16:3"]:
        assert ladder_probe.parse_row(s) == jax_ladder.parse_row(s)
    assert ladder_probe.label(ladder_probe.parse_row("sparse:int4:fp8:416")) == \
        "sparse:int4:float8_e4m3fn:B416"


def test_the_reckoning_and_the_default_rows():
    """The default rows are, for each of the JAX plan's three compositions,
    the largest batch that fit the card and the smallest that ran out of
    memory (the docstring's table); ``kv_bytes_per_sample`` is the bytes of
    the cache ``make_gen_cache`` makes for one bench sample."""
    by_comp = {}
    for s in ladder_probe.DEFAULT_ROWS:
        row = ladder_probe.parse_row(s)
        by_comp.setdefault((row["side"], row["quant"], row["cache_dtype"]), []).append(
            row["batch"])
    assert by_comp == {("sparse", "int8", "int8"): [256, 288],
                       ("dense", "int8", "int8"): [160, 176],
                       ("sparse", "int4", "float8_e4m3fn"): [256, 304]}
    jax_comps = {(r["side"], r["quant"], r["cache_dtype"])
                 for r in map(ladder_probe.parse_row, jax_script("ladder_probe").DEFAULT_ROWS)}
    assert set(by_comp) == jax_comps
    cfg = bench_cfg("small")
    plan = build_inputs(cfg, 1, 12)[0]
    cache = make_gen_cache(cfg, 1, plan.seq_len, 4, torch.int8, device="cpu")
    want = sum(t.numel() * t.element_size() for tier in cache for t in tier if t is not None)
    assert ladder_probe.kv_bytes_per_sample(cfg, "int8", 12, 4) == want > 0
    # a dense sample keeps every token: its cache is the larger
    assert ladder_probe.kv_bytes_per_sample(dense_config(cfg), None, 12, 4) > \
        ladder_probe.kv_bytes_per_sample(cfg, None, 12, 4)


def probe_args(rows, budget):
    return ladder_probe.parser().parse_args(["--model", "small", "--cpu", "--budget-s",
                                             str(budget), "--rows", *rows])


def test_the_probe_records_errors_and_skips_and_goes_on(monkeypatch, capsys):
    clock = [1000.0]
    monkeypatch.setattr(ladder_probe.time, "time", lambda: clock[0])
    seen = []

    def run_row(args, s, timeout):
        seen.append((s, timeout))
        clock[0] += 200  # each row takes 200 s of the budget
        if s.startswith("sparse:int8"):
            return {"error": "Traceback ...\n" + "x" * 500 + "CUDA out of memory. Tried"}
        if s.startswith("dense:int8"):
            return {"error": f"timed out after {timeout:.0f}s"}
        return {"decode_tok_s": 5.0, "ttft_ms": 9.0, "ttft_device_ms": 8.0,
                "live_after_decode_gb": 1.5, "peak_minus_model_gb": 0.5}

    rows = ["sparse:int8:int8:4", "sparse:-:-:2", "dense:int8:int8:2", "sparse:-:-:3"]
    got = ladder_probe.probe(probe_args(rows, 520), run_row)
    # 500 s left for the first row, 300 for the second, 100 (< 120) for the third
    assert [(s, t) for s, t in seen] == [(rows[0], 500.0), (rows[1], 300.0)]
    assert got[0]["row"] == "sparse:int8:int8:B4" and got[0]["error"].endswith("out of memory. Tried")
    assert len(got[0]["error"]) == 400
    assert got[1] == {"row": "sparse:bf16:bf16:B2", "decode_tok_s": 5.0, "ttft_ms": 8.0,
                      "live_gb": 1.5, "peak_minus_model_gb": 0.5}
    assert [set(r) for r in got[2:]] == [{"row", "skipped"}] * 2
    printed = [json.loads(line.split(" ", 1)[1]) for line in capsys.readouterr().out.splitlines()]
    assert printed == got
    # a timeout within a budget-clamped window is a skip, not a failed fit
    clock[0] = 1000.0
    seen.clear()
    got = ladder_probe.probe(probe_args(["dense:int8:int8:2"], 600), run_row)
    assert "skipped" in got[0] and "mid-row" in got[0]["skipped"]
    # the JAX record keys
    jax_keys = literal_dict_keys(ROOT / "run" / "ladder_probe.py", "main")
    assert all(frozenset(r) in jax_keys for r in got)


def test_ladder_cli_records_a_failing_child_and_goes_on():
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "ladder_probe.py"), "--model", "small", "--cpu",
         "--layers", "3", "--new-tokens", "4", "--text-len", "12", "--budget-s", "600",
         "--rows", "sparse:int3:-:1", "sparse:int8:int8:1"],
        cwd=ROOT, env=CHILD_ENV, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    rows = [json.loads(line.split(" ", 1)[1]) for line in lines[:-1]
            if line.startswith("LADDER_ROW ")]
    assert json.loads(lines[-1]) == {"ladder_probe": rows} and len(rows) == 2
    assert rows[0]["row"] == "sparse:int3:bf16:B1" and "int3" in rows[0]["error"]
    assert rows[1]["row"] == "sparse:int8:int8:B1" and rows[1]["decode_tok_s"] > 0


PHASE_SIZES = dict(model="small", quant=None, text=12, spec_new=8, spec_k=3, batch=1,
                   batch_new=4, ring_new=12, window=4, serve_new=4,
                   ladder_fit="sparse:-:-:1", ladder_new=4, ladder_fail="sparse:int3:-:1")


def test_chip_smoke_harnesses_phase_on_the_cpu(monkeypatch, one_prefill_rep):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ladder's child
    cfg = bench_cfg("small")
    params = init_llava_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    params["llm"] = chip_smoke.first_layers(params["llm"], 3)
    out = chip_smoke.harnesses(torch, params, 3, device="cpu", sizes=PHASE_SIZES)
    assert set(out) == {"spec_bench", "spec_batch_bench", "long_gen_bench", "serve_bench",
                        "ladder_probe", "seconds", "wrapper_calls", "phase_s"}
    spec = out["spec_bench"]["detail"]
    assert all(spec[a]["matched_prefix"] == 8 for a in spec_bench_arms()[1:])
    assert spec["spec_oracle"]["rounds"] == 2
    assert out["spec_batch_bench"]["rows"][0]["batch"] == 1
    lg = out["long_gen_bench"]
    assert lg["pre_capacity_ring"] < lg["pre_capacity_drop"]
    assert lg["ring_post_decode_region"] == 4
    assert out["serve_bench"]["worker_tokens"] > 0
    fail, fit = out["ladder_probe"]
    assert "int3" in fail["error"] and fit["decode_tok_s"] > 0
    # the plain versions on the CPU count no kernel launch
    assert set(out["wrapper_calls"].values()) == {0}


def spec_bench_arms():
    import spec_bench

    return spec_bench.ARMS
