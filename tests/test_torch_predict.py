"""``predict_torch.Predictor`` (the cog predictor on the port) against the
JAX ``predict.Predictor`` on one tiny checkpoint
(``helpers.make_tiny_checkpoint``), without cog: at temperature 0 both
stream the same answer, the port's loaded in bf16 on the CPU; a second call
gives the same text; a sampled call streams text."""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX package below runs on the CPU, conftest)

sys.path.insert(0, str(Path(__file__).parent.parent))

from helpers import make_tiny_checkpoint  # noqa: E402

import predict  # noqa: E402
import predict_torch  # noqa: E402

ASK = dict(prompt="What is in the image ?", top_p=1.0, temperature=0.0, max_tokens=6)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("predict")
    ckpt = make_tiny_checkpoint(str(root / "ckpt"))
    img = root / "img.png"
    Image.fromarray(
        np.random.default_rng(0).integers(0, 255, (48, 64, 3)).astype("uint8")).save(img)
    p = predict.Predictor()
    p.setup(model_path=ckpt)
    return {"ckpt": ckpt, "image": str(img), "jax": list(p.predict(image=str(img), **ASK))}


def test_predictor_streams_the_jax_answer(setup):
    p = predict_torch.Predictor()
    p.setup(model_path=setup["ckpt"], device="cpu")
    assert str(p.runtime.params["llm"]["final_ln"].device) == "cpu"
    pieces = list(p.predict(image=setup["image"], **ASK))
    assert pieces and "".join(pieces) == "".join(setup["jax"])
    assert "".join(p.predict(image=setup["image"], **ASK)) == "".join(pieces)
    sampled = "".join(p.predict(image=setup["image"], **dict(ASK, temperature=0.7, top_p=0.9)))
    assert isinstance(sampled, str)
    assert p._gen_key == (6, 0.7, 0.9)  # one kept Generator, replaced


def test_predictor_module_imports_without_cog():
    assert predict_torch.BasePredictor.__module__ == "predict_torch"
    assert predict_torch._input(default=3, description="x") == 3
