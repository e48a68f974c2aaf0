"""``--debug-nans``: raise at the first op that makes a NaN, naming it (the
port of ``jax_debug_nans``, which the JAX trainer sets for the flag).

``DebugNans`` is a ``TorchDispatchMode``: every aten op that runs while it
is on, in the forward and in the backward (the autograd engine carries
the mode to its threads), has its floating outputs checked, and the first
NaN raises ``FloatingPointError`` naming the op and where it ran: the
forward, or the backward of an autograd node. As in JAX only NaN is an
error, not an infinity: the streaming losses start their running maxima
at -inf. Ops that return uninitialized memory (``empty``) and tensors
on the meta device (shapes without values) are not checked.

The hand-written kernels K1-K5 are launched through ``ctypes`` and pass
no dispatcher, so their ``autograd.Function`` wrappers call
``check_outputs`` on what the kernels wrote while the mode is on. Each
check reads one flag from the card, so a step under the mode runs far
slower: it is a debugging aid, not a run mode.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

# ops whose outputs hold uninitialized memory
_UNCHECKED = ("empty", "set_", "resize_")


def active() -> bool:
    """Whether a ``DebugNans`` mode is on in this thread (the autograd
    engine's threads inherit the mode stack of the thread that ran the
    forward)."""
    return any(isinstance(m, DebugNans) for m in _get_current_dispatch_mode_stack())


def _where() -> str:
    node = torch._C._current_autograd_node()
    return "forward" if node is None else f"backward ({node.name()})"


def _leaves(out):
    if torch.is_tensor(out):
        yield out
    elif isinstance(out, (list, tuple)):
        for o in out:
            yield from _leaves(o)


def check_outputs(name: str, out) -> None:
    """Raise ``FloatingPointError`` if a floating tensor in ``out`` holds a
    NaN, naming ``name`` and the phase."""
    for t in _leaves(out):
        if (t.is_floating_point() and t.element_size() > 1 and t.numel()
                and not t.is_meta and bool(torch.isnan(t).any())):
            raise FloatingPointError(
                f"--debug-nans: {name} produced a NaN in the {_where()} "
                f"(output of shape {tuple(t.shape)}, {t.dtype})")


def check_kernel(name: str, *outputs) -> None:
    """What a hand-written kernel's wrapper calls on its outputs: a check
    while the mode is on, nothing otherwise."""
    if active():
        check_outputs(name, outputs)


class DebugNans(TorchDispatchMode):
    """Check every op's outputs for NaN while entered."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        if not any(u in name for u in _UNCHECKED):
            check_outputs(name, out)
        return out
