"""The control plane's typed knob surface.

Counterpart of ``deepspeed_tpu/control/``: so far :mod:`~.knobs`
(:class:`Knob`, :class:`KnobRegistry`, :func:`router_knobs`), which the
scale-out router's role and admission knobs use.  The online controller,
the host profile and the engine's knobs are ROADMAP A10b.
"""
from deepspeed_tpu_torch.control.knobs import Knob, KnobRegistry, router_knobs

__all__ = ["Knob", "KnobRegistry", "router_knobs"]
