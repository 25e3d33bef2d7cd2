"""Conversation prompt templates (the port's own copy of
``dynamic_llava_tpu/conversation.py``, framework-free).

Each separator style is a rendering function dispatched from
``Conversation.get_prompt``. The template data (system strings, role
names, separators) must match LLaVA's byte for byte: trained checkpoints
are conditioned on these exact strings. ``vicuna_v1`` (style TWO) is the
default for all v1.5 models.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import Any, Callable, Dict, List, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()


def _msg_text(message: Any) -> str:
    """Messages may be (text, image, ...) tuples in the serving UI."""
    return message[0] if isinstance(message, tuple) else message


def _render_single(conv: "Conversation", msgs) -> str:
    out = [conv.system, conv.sep]
    for role, message in msgs:
        if message:
            out += [role, ": ", _msg_text(message), conv.sep]
        else:
            out += [role, ":"]
    return "".join(out)


def _render_two(conv: "Conversation", msgs) -> str:
    seps = (conv.sep, conv.sep2)
    out = [conv.system, seps[0]]
    for i, (role, message) in enumerate(msgs):
        if message:
            out += [role, ": ", _msg_text(message), seps[i % 2]]
        else:
            out += [role, ":"]
    return "".join(out)


def _render_mpt(conv: "Conversation", msgs) -> str:
    out = [conv.system, conv.sep]
    for role, message in msgs:
        if message:
            out += [role, _msg_text(message), conv.sep]
        else:
            out += [role]
    return "".join(out)


def _render_plain(conv: "Conversation", msgs) -> str:
    seps = (conv.sep, conv.sep2)
    out = [conv.system]
    for i, (_, message) in enumerate(msgs):
        if message:
            out += [_msg_text(message), seps[i % 2]]
    return "".join(out)


def _render_llama2(conv: "Conversation", msgs) -> str:
    out = []
    for i, (role, message) in enumerate(msgs):
        if i == 0:
            assert message, "first message should not be none"
            assert role == conv.roles[0], "first message should come from user"
        if not message:
            continue
        text = _msg_text(message)
        if i == 0 and conv.system:
            text = f"<<SYS>>\n{conv.system}\n<</SYS>>\n\n" + text
        if i % 2 == 0:
            out += [conv.sep, f"[INST] {text} [/INST]"]
        else:
            out += [" ", text, " ", conv.sep2]
    return "".join(out).lstrip(conv.sep)


_RENDERERS: Dict[SeparatorStyle, Callable] = {
    SeparatorStyle.SINGLE: _render_single,
    SeparatorStyle.TWO: _render_two,
    SeparatorStyle.MPT: _render_mpt,
    SeparatorStyle.PLAIN: _render_plain,
    SeparatorStyle.LLAMA_2: _render_llama2,
}


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Any]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = None
    version: str = "Unknown"
    skip_next: bool = False

    def get_prompt(self) -> str:
        msgs = self.messages
        # first message may carry the image tuple; normalize the <image> tag
        if msgs and isinstance(msgs[0][1], tuple):
            msgs = [list(m) for m in msgs]
            role0, payload = msgs[0]
            stripped = payload[0].replace("<image>", "").strip()
            if "mmtag" in self.version:
                msgs[0] = [role0, stripped]
                msgs.insert(0, [self.roles[0], "<Image><image></Image>"])
                msgs.insert(1, [self.roles[1], "Received."])
            else:
                msgs[0] = [role0, "<image>\n" + stripped]
        return _RENDERERS[self.sep_style](self, msgs)

    def append_message(self, role: str, message: Any) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def dict(self) -> dict:
        return {
            "system": self.system,
            "roles": self.roles,
            "messages": [[r, _msg_text(m)] for r, m in self.messages],
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


def _make(name: str, **kw) -> Conversation:
    conv = Conversation(messages=[], offset=0, **kw)
    conv_templates[name] = conv
    return conv


conv_templates: Dict[str, Conversation] = {}

_SYS_V0 = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions."
)
_SYS_V1 = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions."
)
_SYS_MMTAG = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant is able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>."
)

# v0's few-shot seed conversation (LLaVA's conv_vicuna_v0 messages;
# offset=2 so it is skipped by chat UIs but rendered into prompts)
_V0_SEED_Q = 'What are the key differences between renewable and non-renewable energy sources?'
_V0_SEED_A = (
    'Renewable energy sources are those that can be replenished naturally in '
    'a relatively short amount of time, such as solar, wind, hydro, geotherma'
    'l, and biomass. Non-renewable energy sources, on the other hand, are fin'
    'ite and will eventually be depleted, such as coal, oil, and natural gas.'
    ' Here are some key differences between renewable and non-renewable energ'
    'y sources:\n1. Availability: Renewable energy sources are virtually inexh'
    'austible, while non-renewable energy sources are finite and will eventua'
    'lly run out.\n2. Environmental impact: Renewable energy sources have a mu'
    'ch lower environmental impact than non-renewable sources, which can lead'
    ' to air and water pollution, greenhouse gas emissions, and other negativ'
    'e effects.\n3. Cost: Renewable energy sources can be more expensive to in'
    'itially set up, but they typically have lower operational costs than non'
    '-renewable sources.\n4. Reliability: Renewable energy sources are often m'
    'ore reliable and can be used in more remote locations than non-renewable'
    ' sources.\n5. Flexibility: Renewable energy sources are often more flexib'
    'le and can be adapted to different situations and needs, while non-renew'
    'able sources are more rigid and inflexible.\n6. Sustainability: Renewable'
    ' energy sources are more sustainable over the long term, while non-renew'
    'able sources are not, and their depletion can lead to economic and socia'
    'l instability.\n'
)

conv_vicuna_v0 = _make(
    "v0", system=_SYS_V0, roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.SINGLE, sep="###",
)
conv_vicuna_v0.messages = [
    ["Human", _V0_SEED_Q],
    ["Assistant", "".join(_V0_SEED_A) if isinstance(_V0_SEED_A, tuple) else _V0_SEED_A],
]
conv_vicuna_v0.offset = 2
conv_vicuna_v1 = _make(
    "v1", system=_SYS_V1, roles=("USER", "ASSISTANT"), version="v1",
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>",
)
_SYS_LLAMA2_SAFETY = (
    "You are a helpful, respectful and honest assistant. Always answer as "
    "helpfully as possible, while being safe.  Your answers should not "
    "include any harmful, unethical, racist, sexist, toxic, dangerous, or "
    "illegal content. Please ensure that your responses are socially "
    "unbiased and positive in nature.\n\n"
    "If a question does not make any sense, or is not factually coherent, "
    "explain why instead of answering something not correct. If you don't "
    "know the answer to a question, please don't share false information."
)
_SYS_LLAVA_LLAMA2 = (
    "You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
)

conv_llama_2 = _make(
    "llama_2", system=_SYS_LLAMA2_SAFETY,
    roles=("USER", "ASSISTANT"), version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>",
)
conv_llava_llama_2 = _make(
    "llava_llama_2", system=_SYS_LLAVA_LLAMA2,
    roles=("USER", "ASSISTANT"), version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>",
)
conv_mpt = _make(
    "mpt",
    system=(
        "<|im_start|>system\nA conversation between a user and an LLM-based AI "
        "assistant. The assistant gives helpful and honest answers."
    ),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"), version="mpt",
    sep_style=SeparatorStyle.MPT, sep="<|im_end|>",
)
conv_llava_plain = _make(
    "plain", system="", roles=("", ""), sep_style=SeparatorStyle.PLAIN, sep="\n",
)
conv_llava_v0 = _make(
    "llava_v0", system=_SYS_V0, roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.SINGLE, sep="###",
)
conv_llava_v0_mmtag = _make(
    "v0_mmtag",
    system=_SYS_MMTAG.replace("curious user", "curious user"),
    roles=("Human", "Assistant"), version="v0_mmtag",
    sep_style=SeparatorStyle.SINGLE, sep="###",
)
conv_llava_v1 = _make(
    "llava_v1", system=_SYS_V0, roles=("USER", "ASSISTANT"), version="v1",
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>",
)
conv_llava_v1_mmtag = _make(
    "v1_mmtag", system=_SYS_MMTAG, roles=("USER", "ASSISTANT"),
    version="v1_mmtag", sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>",
)
# chatml_direct renders with the MPT formatter (roles carry the trailing
# newline, no newline after <|im_end|>), as LLaVA's own template does: byte
# parity matters, trained checkpoints are conditioned on the exact string.
conv_chatml_direct = _make(
    "chatml_direct", system="<|im_start|>system\nAnswer the questions.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"), version="mpt",
    sep_style=SeparatorStyle.MPT, sep="<|im_end|>",
)
# Mistral-instruct: llama-2 bracket format with no system prompt and no
# leading <s>.
conv_mistral_instruct = _make(
    "mistral_instruct", system="", roles=("USER", "ASSISTANT"),
    version="llama_v2", sep_style=SeparatorStyle.LLAMA_2, sep="", sep2="</s>",
)

conv_templates["default"] = conv_vicuna_v0
conv_templates["vicuna_v1"] = conv_vicuna_v1
conv_templates["v0_plain"] = conv_llava_plain
conv_templates["mistral_direct"] = conv_chatml_direct

default_conversation = conv_vicuna_v1
