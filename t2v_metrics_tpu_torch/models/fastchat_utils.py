"""Conversation templates (a copy of t2v_metrics_tpu/models/fastchat_utils.py,
under the same names; InternVL builds its prompts with them).

The reference vendors FastChat's Conversation machinery for InternVL prompt
building (reference t2v_metrics/models/vqascore_models/fastchat_utils.py:
Conversation/SeparatorStyle :15-199, registry :320-337, four registered
templates :339-390): the separator styles those templates use (MPT-style
role blocks) plus the common colon styles, with the same four templates
registered. ``internvl2_5``'s system message is not ASCII.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum, auto
from typing import Optional


class SeparatorStyle(IntEnum):
    ADD_COLON_SINGLE = auto()
    ADD_COLON_TWO = auto()
    NO_COLON_SINGLE = auto()
    MPT = auto()
    CHATML = auto()


@dataclasses.dataclass
class Conversation:
    """A stateful prompt template: system + alternating role messages."""

    name: str
    system_template: str = "{system_message}"
    system_message: str = ""
    roles: tuple = ("USER", "ASSISTANT")
    messages: list = dataclasses.field(default_factory=list)
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.ADD_COLON_SINGLE
    sep: str = "\n"
    sep2: Optional[str] = None
    stop_str: Optional[str] = None
    stop_token_ids: Optional[list] = None

    def set_system_message(self, message: str):
        self.system_message = message

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append([role, message])

    def update_last_message(self, message: str):
        self.messages[-1][1] = message

    def get_prompt(self) -> str:
        system = self.system_template.format(system_message=self.system_message)
        if self.sep_style in (SeparatorStyle.MPT, SeparatorStyle.CHATML):
            ret = system + self.sep if system else ""
            for role, message in self.messages:
                if message:
                    ret += role + message + self.sep
                    if self.sep_style == SeparatorStyle.CHATML:
                        ret += "\n"
                else:
                    ret += role
            return ret
        if self.sep_style == SeparatorStyle.ADD_COLON_SINGLE:
            ret = system + self.sep
            for role, message in self.messages:
                ret += f"{role}: {message}{self.sep}" if message else f"{role}:"
            return ret
        if self.sep_style == SeparatorStyle.ADD_COLON_TWO:
            seps = [self.sep, self.sep2]
            ret = system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                ret += (f"{role}: {message}{seps[i % 2]}" if message
                        else f"{role}:")
            return ret
        if self.sep_style == SeparatorStyle.NO_COLON_SINGLE:
            ret = system
            for role, message in self.messages:
                ret += role + (message + self.sep if message else "")
            return ret
        raise NotImplementedError(self.sep_style)

    def copy(self) -> "Conversation":
        return Conversation(
            name=self.name, system_template=self.system_template,
            system_message=self.system_message, roles=self.roles,
            messages=[[r, m] for r, m in self.messages], offset=self.offset,
            sep_style=self.sep_style, sep=self.sep, sep2=self.sep2,
            stop_str=self.stop_str, stop_token_ids=self.stop_token_ids)


conv_templates: dict[str, Conversation] = {}


def register_conv_template(template: Conversation, override: bool = False):
    if not override:
        assert template.name not in conv_templates, \
            f"{template.name} already registered"
    conv_templates[template.name] = template


def get_conv_template(name: str) -> Conversation:
    return conv_templates[name].copy()


_INTERNVL_SYSTEM_OLD = ("你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，"
                        "英文名叫InternVL, 是一个有用无害的人工智能助手。")
_INTERNVL_SYSTEM_NEW = ("你是书生·万象，英文名是InternVL，是由上海人工智能实验室、"
                        "清华大学及多家合作单位联合开发的多模态大语言模型。")

# The four templates the reference registers (fastchat_utils.py:339-390).
register_conv_template(Conversation(
    name="Hermes-2",
    system_template="<|im_start|>system\n{system_message}",
    system_message=_INTERNVL_SYSTEM_OLD,
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
    stop_str="<|endoftext|>",
))

register_conv_template(Conversation(
    name="internlm2-chat",
    system_template="<|im_start|>system\n{system_message}",
    system_message=_INTERNVL_SYSTEM_OLD,
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
))

register_conv_template(Conversation(
    name="phi3-chat",
    system_template="<|system|>\n{system_message}",
    system_message=_INTERNVL_SYSTEM_OLD,
    roles=("<|user|>\n", "<|assistant|>\n"),
    sep_style=SeparatorStyle.MPT,
    sep="<|end|>",
))

register_conv_template(Conversation(
    name="internvl2_5",
    system_template="<|im_start|>system\n{system_message}",
    system_message=_INTERNVL_SYSTEM_NEW,
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>\n",
))
