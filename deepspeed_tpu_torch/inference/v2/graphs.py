"""The decode block's static buffers, and its CUDA graphs (ROADMAP A8b,
the v2 half).

The reference compiles its decode block, K ticks in a ``lax.scan``, into
one XLA program per ``sampled`` flag
(``deepspeed_tpu/inference/v2/ragged_engine.py:1538-1617``).  The port's
counterpart of that jit is a CUDA graph.  :class:`DecodeBlockGraphs`
holds static device buffers for the block's carry (``last_tok``, ``pos``,
``active``, ``remaining``) and its inputs (the page table, ``eos_ids``
and the samplers' settings).  Every decode block of the engine runs over
them: inputs enter by ``copy_`` and are never rebound, and a pipelined
loop copies a block's carry outputs back into the carry inputs on the
stream, so the next block continues where the last one stopped with no
host round trip.  With ``enable_cuda_graph`` on ``cuda`` it captures
:meth:`RaggedInferenceEngineV2._decode_block` over the buffers once per
``sampled`` flag (at most two graphs an engine, in one shared memory
pool) and replays them; otherwise ``run`` calls the same block eagerly
over the same buffers.  The two paths differ only in ``run``.

Capture never touches a live page: the warm-up that precedes it runs for
real, so both run over an all-inactive carry, and every K/V write of an
inactive row lands on the trash page (``dest`` 0), as finished rows'
writes do in a live block.  Everything the block launches depends on
shapes only (the paged kernels' split plan, the ctypes launches on the
current stream), and its temporaries (the split-KV scratch, every int8
weight's dequantized copy) come from the graph's pool.

A kernel wrapper's Python ``.launches`` counter ticks when Python calls
it: at the warm-up and at the capture, never at a replay.  On the card a
captured block's device launches are therefore derived as (warm-ups +
replays) x K ticks, from the engine's ``graph_captures`` and
``graph_replays``.
"""
from __future__ import annotations

import time
import weakref
from typing import Dict, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.inference.common import capture_graph

CARRY = ("last_tok", "pos", "active", "remaining")
META = ("page_table", "eos_ids", "do_sample", "temperature", "top_k",
        "top_p", "seeds")
INPUTS = CARRY + META        # _decode_block's arguments after `sampled`

# buffer: (dtype, the all-inactive value warm-up and capture run over)
_SPEC = {"last_tok": (torch.int64, 0), "pos": (torch.int64, 0),
         "active": (torch.bool, False), "remaining": (torch.int64, 0),
         "page_table": (torch.int32, -1), "eos_ids": (torch.int64, -1),
         "do_sample": (torch.bool, False),
         "temperature": (torch.float32, 1.0), "top_k": (torch.int64, 0),
         "top_p": (torch.float32, 1.0), "seeds": (torch.int64, 0)}


class DecodeBlockGraphs:
    """One engine's static decode-block buffers and, when ``capture`` on
    ``cuda``, its (at most two) captured graphs.  ``run(sampled)``
    returns the block's outputs ``(last_tok, pos, active, remaining,
    toks [K,S], mask [K,S])``: the graph's static outputs when captured
    (valid until the next replay), fresh tensors otherwise."""

    def __init__(self, engine, capture: bool):
        # weakly: the engine holds this object, and a cycle would keep
        # its KV pools alive after the caller drops it, until a gc pass
        self.engine = weakref.proxy(engine)
        S, pp = engine.max_seqs, engine.pages_per_seq
        dev = engine.device
        # created in inference mode, as the block runs: copy_ into an
        # inference tensor is refused outside it
        with torch.inference_mode():
            self.static: Dict[str, torch.Tensor] = {
                name: torch.full((S, pp) if name == "page_table" else (S,),
                                 fill, dtype=dtype, device=dev)
                for name, (dtype, fill) in _SPEC.items()}
        self.capturing = bool(capture) and dev.type == "cuda"
        self.pool = (torch.cuda.graph_pool_handle() if self.capturing
                     else None)
        self.graphs: Dict[bool, torch.cuda.CUDAGraph] = {}
        self.outputs: Dict[bool, Tuple[torch.Tensor, ...]] = {}

    def _args(self):
        return [self.static[name] for name in INPUTS]

    def load(self, name: str, array: np.ndarray) -> None:
        """One host array into its static buffer (one counted upload)."""
        self.engine._upload_into(self.static[name], array)

    def ensure(self, sampled: bool) -> None:
        """Capture the ``sampled`` graph if this engine has not yet.  Call
        before loading a block's inputs: capture resets every static
        buffer to the all-inactive values."""
        if not self.capturing or sampled in self.graphs:
            return
        st = self.engine.host_stats
        t0 = time.perf_counter()
        with torch.inference_mode():
            for name, (_, fill) in _SPEC.items():
                self.static[name].fill_(fill)
            self.graphs[sampled], self.outputs[sampled] = capture_graph(
                lambda: self.engine._decode_block(sampled, *self._args()),
                pool=self.pool)
        st.graph_captures += 1
        st.graph_capture_s += time.perf_counter() - t0

    def run(self, sampled: bool) -> Tuple[torch.Tensor, ...]:
        """One decode block over the static buffers: a replay when
        captured, the same block called eagerly otherwise."""
        if not self.capturing:
            return self.engine._decode_block(sampled, *self._args())
        if sampled not in self.graphs:
            raise RuntimeError(f"no captured decode block for sampled="
                               f"{sampled}: ensure() it before the loads")
        self.graphs[sampled].replay()
        self.engine.host_stats.graph_replays += 1
        return self.outputs[sampled]

    def chain(self, out: Tuple[torch.Tensor, ...]) -> None:
        """Copy a block's carry outputs into the static carry inputs, on
        the stream: the next block continues this one's sequences."""
        with torch.inference_mode():
            for name, t in zip(CARRY, out):
                self.static[name].copy_(t)
