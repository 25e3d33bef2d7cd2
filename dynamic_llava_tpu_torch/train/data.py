"""Supervised fine-tuning data pipeline (mix665k format): the port's own
copy of ``dynamic_llava_tpu/train/data.py``.

Rebuild of the reference dataset stack (the reference's
``llava/train/train_sparse.py:370-937``): dialect-specific prompt
construction + label masking (``preprocess_plain`` :685,
``preprocess_v1`` :497, ``preprocess_mpt`` :587, ``preprocess_llama_2``
:411), the lazy JSON dataset with ``requires_image`` filtering (:774-890),
and the modality-grouped length sampler (dynamic_llava_trainer.py:64-191).

No torch DataLoader and no torch tensors: samples come out as numpy
(input_ids, labels, image NHWC) and the collator emits a ``FusionPlan``,
which ``Trainer.train`` moves to the device (``train.step.batch_from_plan``).
The collator rounds the fused length up to ``pad_bucket`` as the JAX one
does: the batches equal the JAX pipeline's, and a caching allocator sees
few distinct shapes.
"""

from __future__ import annotations

import copy
import json
import os
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    IGNORE_INDEX,
)
from .. import conversation as conversation_lib
from ..conversation import SeparatorStyle
from ..mm_utils import ClipImagePreprocessor, expand2square, tokenizer_image_token
from ..multimodal.fusion import FusionPlan, plan_batch


def _tokenizers_geq_0_14() -> bool:
    try:
        import tokenizers

        parts = tokenizers.__version__.split(".")[:2]
        return (int(parts[0]), int(parts[1])) >= (0, 14)
    except (ImportError, ValueError, IndexError):
        return True


IS_TOKENIZER_GREATER_THAN_0_14 = _tokenizers_geq_0_14()


# ---------------------------------------------------------------------------
# Prompt construction + label masking
# ---------------------------------------------------------------------------


def preprocess_multimodal(
    sources, mm_use_im_start_end: bool = False, is_multimodal: bool = True
):
    """Normalize the <image> tag position (front + newline) and optionally
    wrap with im_start/im_end (reference :381-409)."""
    if not is_multimodal:
        return sources
    version = conversation_lib.default_conversation.version
    for source in sources:
        for sentence in source:
            if DEFAULT_IMAGE_TOKEN in sentence["value"]:
                stripped = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
                sentence["value"] = (DEFAULT_IMAGE_TOKEN + "\n" + stripped).strip()
                if "mmtag" in version:
                    sentence["value"] = sentence["value"].replace(
                        DEFAULT_IMAGE_TOKEN,
                        "<Image>" + DEFAULT_IMAGE_TOKEN + "</Image>",
                    )
            if mm_use_im_start_end:
                sentence["value"] = sentence["value"].replace(
                    DEFAULT_IMAGE_TOKEN,
                    DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN,
                )
    return sources


def _ids(tokenizer, text: str, has_image: bool) -> List[int]:
    if has_image:
        return list(tokenizer_image_token(text, tokenizer))
    return list(tokenizer(text).input_ids)


def preprocess_plain(sources, tokenizer) -> Dict[str, List[np.ndarray]]:
    """Pretraining dialect: <image> + caption + sep, caption supervised."""
    conv = conversation_lib.default_conversation
    input_ids, labels = [], []
    for source in sources:
        assert len(source) == 2
        assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
        prompt = DEFAULT_IMAGE_TOKEN + source[1]["value"] + conv.sep
        ids = np.asarray(tokenizer_image_token(prompt, tokenizer), np.int64)
        lab = ids.copy()
        lab[: len(tokenizer_image_token(DEFAULT_IMAGE_TOKEN, tokenizer))] = IGNORE_INDEX
        input_ids.append(ids)
        labels.append(lab)
    return dict(input_ids=input_ids, labels=labels)


def _build_conversations(sources, conv) -> List[str]:
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    out = []
    for i, source in enumerate(sources):
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2], f"{i}"
            conv.append_message(role, sentence["value"])
        out.append(conv.get_prompt())
    return out


def preprocess_v1(sources, tokenizer, has_image: bool = False):
    """vicuna_v1 dialect: rounds split on '</s>', instruction spans masked.

    The -2/-1 token-count corrections replicate the reference exactly
    (train_sparse.py:541-571), including the tokenizers>=0.14 non-legacy
    off-by-one — required for bit-identical labels against reference-trained
    data."""
    conv = conversation_lib.default_conversation.copy()
    conversations = _build_conversations(sources, conv)
    assert conv.sep_style == SeparatorStyle.TWO

    input_ids = [
        np.asarray(_ids(tokenizer, prompt, has_image), np.int64)
        for prompt in conversations
    ]
    labels = []
    sep = conv.sep + conv.roles[1] + ": "
    legacy = getattr(tokenizer, "legacy", True)
    for prompt, ids in zip(conversations, input_ids):
        target = ids.copy()
        pad_id = tokenizer.pad_token_id
        total_len = int((ids != pad_id).sum()) if pad_id is not None else len(ids)
        rounds = prompt.split(conv.sep2)
        cur = 1
        target[:cur] = IGNORE_INDEX
        for i, rou in enumerate(rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_ids(tokenizer, rou, has_image))
            instruction_len = len(_ids(tokenizer, parts[0], has_image)) - 2
            if i != 0 and not legacy and IS_TOKENIZER_GREATER_THAN_0_14:
                round_len -= 1
                instruction_len -= 1
            target[cur : cur + instruction_len] = IGNORE_INDEX
            cur += round_len
        target[cur:] = IGNORE_INDEX
        if cur < getattr(tokenizer, "model_max_length", 1 << 30) and cur != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur} vs. {total_len}. (ignored)")
        labels.append(target)
    return dict(input_ids=input_ids, labels=labels)


def preprocess_mpt(sources, tokenizer, has_image: bool = False):
    conv = conversation_lib.conv_templates["mpt"].copy()
    conversations = _build_conversations(sources, conv)
    input_ids = [
        np.asarray(_ids(tokenizer, prompt, has_image), np.int64)
        for prompt in conversations
    ]
    labels = []
    sep = conv.sep + conv.roles[1]
    for prompt, ids in zip(conversations, input_ids):
        target = ids.copy()
        rounds = prompt.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]
        for idx in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[idx : idx + 2]))
        cur = 0
        target[:cur] = IGNORE_INDEX
        for i, rou in enumerate(re_rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_ids(tokenizer, rou, has_image)) + len(
                _ids(tokenizer, conv.sep, False)
            )
            instruction_len = len(_ids(tokenizer, parts[0], has_image))
            target[cur : cur + instruction_len] = IGNORE_INDEX
            cur += round_len
        target[cur:] = IGNORE_INDEX
        labels.append(target)
    return dict(input_ids=input_ids, labels=labels)


def preprocess_llama_2(sources, tokenizer, has_image: bool = False):
    conv = conversation_lib.conv_templates["llama_2"].copy()
    conversations = _build_conversations(sources, conv)
    input_ids = [
        np.asarray(_ids(tokenizer, prompt, has_image), np.int64)
        for prompt in conversations
    ]
    labels = []
    sep = "[/INST] "
    for prompt, ids in zip(conversations, input_ids):
        target = ids.copy()
        rounds = prompt.split(conv.sep2)
        cur = 1
        target[:cur] = IGNORE_INDEX
        for i, rou in enumerate(rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_ids(tokenizer, rou, has_image))
            instruction_len = len(_ids(tokenizer, parts[0], has_image)) - 2
            target[cur : cur + instruction_len] = IGNORE_INDEX
            cur += round_len
        target[cur:] = IGNORE_INDEX
        labels.append(target)
    return dict(input_ids=input_ids, labels=labels)


def preprocess(sources, tokenizer, has_image: bool = False):
    """Dialect dispatcher keyed on the default conversation template
    (reference :714-772)."""
    conv = conversation_lib.default_conversation
    if conv.sep_style == SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer)
    if conv.sep_style == SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image=has_image)
    if conv.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, has_image=has_image)
    if conv.version == "mpt":
        return preprocess_mpt(sources, tokenizer, has_image=has_image)
    raise NotImplementedError(f"no preprocessor for template {conv.version}")


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


@dataclass
class DataArguments:
    data_path: str = ""
    lazy_preprocess: bool = True
    is_multimodal: bool = True
    image_folder: str = ""
    image_aspect_ratio: str = "pad"
    requires_image: bool = False  # drop text-only samples (reference :96)
    mm_use_im_start_end: bool = False


class LazySupervisedDataset:
    """Lazy mix665k-format dataset: JSON parsed once, tokenization and image
    IO happen per access (reference :774-890)."""

    def __init__(self, data_path: str, tokenizer, data_args: DataArguments,
                 image_processor: Optional[ClipImagePreprocessor] = None):
        with open(data_path) as f:
            records = json.load(f)
        if data_args.requires_image:
            records = [r for r in records if "image" in r]
        self.records = records
        self.tokenizer = tokenizer
        self.data_args = data_args
        self.image_processor = image_processor or ClipImagePreprocessor()

    def __len__(self) -> int:
        return len(self.records)

    @property
    def lengths(self) -> List[int]:
        out = []
        for r in self.records:
            img_tokens = 128 if "image" in r else 0
            out.append(
                sum(len(c["value"].split()) for c in r["conversations"]) + img_tokens
            )
        return out

    @property
    def modality_lengths(self) -> List[int]:
        """Positive for multimodal samples, negative for text-only
        (the grouped sampler keys on the sign; reference :806-820)."""
        out = []
        for r in self.records:
            n = sum(len(c["value"].split()) for c in r["conversations"])
            out.append(n if "image" in r else -n)
        return out

    def _load_image(self, rel_path: str) -> np.ndarray:
        from PIL import Image

        path = os.path.join(self.data_args.image_folder, rel_path)
        image = Image.open(path).convert("RGB")
        if self.data_args.image_aspect_ratio == "pad":
            # fast path: the native C++ fused pad+resize+normalize
            from ..native import clip_preprocess_batch_native, native_available

            if native_available():
                return clip_preprocess_batch_native(
                    [np.asarray(image, np.uint8)],
                    self.image_processor.crop_size,
                    self.image_processor.background_color,
                    self.image_processor.image_mean,
                    self.image_processor.image_std,
                )[0]
            image = expand2square(image, self.image_processor.background_color)
        return self.image_processor(image)

    def __getitem__(self, i: int) -> Dict:
        record = self.records[i]
        sources = [copy.deepcopy(record["conversations"])]
        has_image = "image" in record
        if has_image:
            sources = preprocess_multimodal(
                sources,
                mm_use_im_start_end=self.data_args.mm_use_im_start_end,
                is_multimodal=self.data_args.is_multimodal,
            )
        out = preprocess(sources, self.tokenizer, has_image=has_image)
        item = dict(input_ids=out["input_ids"][0], labels=out["labels"][0])
        if has_image:
            item["image"] = self._load_image(record["image"])
        elif self.data_args.is_multimodal:
            # text-only sample in a multimodal batch: zero image, no
            # <image> token (the fused plan marks has_image=False)
            size = self.image_processor.crop_size
            item["image"] = np.zeros((size, size, 3), np.float32)
        return item


# ---------------------------------------------------------------------------
# Collation -> FusionPlan batches
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class Collator:
    """Right-pads a list of samples into one FusionPlan batch. ``pad_bucket``
    rounds the fused length up, as the JAX collator does: the batches equal
    the JAX pipeline's, and the allocator sees few distinct shapes."""

    num_image_tokens: int
    model_max_length: int = 2048
    pad_bucket: int = 128

    def __call__(self, samples: Sequence[Dict]) -> Tuple[FusionPlan, Optional[np.ndarray]]:
        ids = [s["input_ids"] for s in samples]
        labels = [s["labels"] for s in samples]
        plan = plan_batch(
            ids,
            self.num_image_tokens,
            labels_list=labels,
            max_length=self.model_max_length,
        )
        bucket = min(
            _round_up(plan.seq_len, self.pad_bucket),
            _round_up(self.model_max_length + self.num_image_tokens, self.pad_bucket),
        )
        if bucket > plan.seq_len:
            plan = plan_batch(
                ids,
                self.num_image_tokens,
                labels_list=labels,
                max_length=self.model_max_length,
                pad_to=bucket,
            )
        images = None
        if any("image" in s for s in samples):
            images = np.stack([s["image"] for s in samples])
        return plan, images


class GroupedLengthSampler:
    """Modality-grouped length sampler: shuffles, then forms megabatches
    sorted by length with multimodal and text-only samples grouped
    (reference dynamic_llava_trainer.py:64-191)."""

    def __init__(self, lengths: Sequence[int], batch_size: int, world_size: int = 1,
                 seed: int = 0):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.world_size = world_size
        self.seed = seed

    def __iter__(self) -> Iterator[int]:
        rng = random.Random(self.seed)
        mm = [i for i, l in enumerate(self.lengths) if l > 0]
        lang = [i for i, l in enumerate(self.lengths) if l <= 0]
        for group in (mm, lang):
            rng.shuffle(group)
        mega = self.batch_size * self.world_size * 50
        batches: List[List[int]] = []
        for group in (mm, lang):
            for ofs in range(0, len(group), mega):
                chunk = sorted(
                    group[ofs : ofs + mega], key=lambda i: abs(self.lengths[i]),
                    reverse=True,
                )
                for b in range(0, len(chunk), self.batch_size):
                    batches.append(chunk[b : b + self.batch_size])
        rng.shuffle(batches)
        for batch in batches:
            yield from batch


def data_loader(
    dataset: LazySupervisedDataset,
    collator: Collator,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    group_by_modality_length: bool = True,
    drop_last: bool = True,
) -> Iterator[Tuple[FusionPlan, Optional[np.ndarray]]]:
    n = len(dataset)
    if group_by_modality_length:
        order = list(GroupedLengthSampler(dataset.modality_lengths, batch_size, seed=seed))
    elif shuffle:
        order = list(range(n))
        random.Random(seed).shuffle(order)
    else:
        order = list(range(n))
    for ofs in range(0, n - (batch_size - 1 if drop_last else 0), batch_size):
        idx = order[ofs : ofs + batch_size]
        if not idx:
            break
        samples = [dataset[i] for i in idx]
        yield collator(samples)
