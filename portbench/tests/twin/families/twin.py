"""A family for the tests alone: the Llama family under another
architecture name, its K3 calls counted under a kernel class of its own.
Found through ``registry.ROOTS``, it shows that a new family is new files:
the serve driver runs it, ``trace.summarize`` classes its kernel, and a
roofline metric (``metrics/twin_roofline.py`` beside it) reads its bound,
with no shared module edited."""

from portbench.families import llama
from portbench.families.llama import (  # noqa: F401 (the family's parts)
    forward_flops, live_config, make_decoder, port_forward, reference)

ARCHITECTURES = ("TwinForCausalLM",)
KERNEL_CLASSES = (("Ktwin", lambda n: "twin_attn" in n),)


def kernel_calls(c, offsets, S):
    return {"Ktwin": llama.kernel_calls(c, offsets, S)["K3"]}
