"""The decode blocks' static buffers, and their CUDA graphs (ROADMAP A8b,
the v2 half, and the speculative block of A9.4).

The reference compiles its decode block, K ticks in a ``lax.scan``, into
one XLA program per ``sampled`` flag
(``deepspeed_tpu/inference/v2/ragged_engine.py:1538-1617``), and its
speculative block, K draft + verify ticks, into another
(``_spec_block_fn``, ``:1765-1966``).  The port's counterpart of those
jits is a CUDA graph.  :class:`DecodeBlockGraphs` holds static device
buffers for the blocks' carry (``last_tok``, ``pos``, ``active``,
``remaining``) and inputs (the page table, ``eos_ids``, the samplers'
settings and their keys' uids), plus, with speculation on, the token
history ``hist`` ``[S, max_seq_len + 1]`` the drafters read (the last
column is a trash column that inactive rows write to, where the
reference's scatter drops an out-of-range index).  Every
decode block of the engine, plain or speculative, runs over them:
inputs enter by ``copy_`` and are never rebound, a speculative block
updates ``hist`` in place, and a pipelined loop copies a block's carry
outputs back into the carry inputs on the stream, so the next block
continues where the last one stopped with no host round trip.  With
``enable_cuda_graph`` on ``cuda`` it captures
:meth:`RaggedInferenceEngineV2._decode_block` and, with speculation on,
:meth:`RaggedInferenceEngineV2._spec_block` over the buffers once per
(block, ``sampled``) pair (at most four graphs an engine, in one shared
memory pool) and replays them; otherwise ``run`` calls the same block
eagerly over the same buffers.  The two paths differ only in ``run``.

Capture never touches a live page: the warm-up that precedes it runs for
real, so both run over an all-inactive carry, and every K/V write of an
inactive row lands on the trash page (``dest`` 0), as finished rows'
writes do in a live block: in the target's pools and, in draft mode, in
the draft model's pools too; an inactive row's history write lands on
the trash column.  Everything the blocks launch depends on shapes only
(the paged kernels' split plan, the ctypes launches on the current
stream), and their temporaries (the split-KV scratch, every quantized
weight's dequantized copy, a W8A8 Linear's int8 rows and int32 product)
come from the graphs' pool.

A kernel wrapper's Python ``.launches`` counter ticks when Python calls
it: at the warm-up and at the capture, never at a replay.  On the card a
captured block's device launches are therefore derived as (warm-ups +
replays) x K ticks, from the engine's ``graph_captures`` and
``graph_replays``; by block, the captured keys are ``graphs``' and every
speculative dispatch of a capturing engine is a replay
(``spec_dispatches``).
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
_BUFFERS = {"last_tok": (torch.int64, 0), "pos": (torch.int64, 0),
         "active": (torch.bool, False), "remaining": (torch.int64, 0),
         "page_table": (torch.int32, -1), "eos_ids": (torch.int64, -1),
         "do_sample": (torch.bool, False),
         "temperature": (torch.float32, 1.0), "top_k": (torch.int64, 0),
         "top_p": (torch.float32, 1.0), "seeds": (torch.int64, 0)}


class DecodeBlockGraphs:
    """One engine's static decode-block buffers and, when ``capture`` on
    ``cuda``, its captured graphs, one per (``spec``, ``sampled``).
    ``run(sampled, spec)`` returns the block's outputs ``(last_tok, pos,
    active, remaining, toks, mask)``, and for a speculative block
    ``(prop, accd)`` after them: the graph's static outputs when
    captured (valid until the next replay), fresh tensors otherwise."""

    def __init__(self, engine, capture: bool):
        # weakly: the engine holds this object, and a cycle would keep
        # its KV pools alive after the caller drops it, until a gc pass
        self.engine = weakref.proxy(engine)
        S, pp = engine.max_seqs, engine.pages_per_seq
        dev = engine.device
        self.fills = dict(_BUFFERS)
        shapes = {"page_table": (S, pp)}
        if engine.spec_mode != "off":
            self.fills["hist"] = (torch.int64, 0)
            shapes["hist"] = (S, engine.max_seq_len + 1)
        # created in inference mode, as the block runs: copy_ into an
        # inference tensor is refused outside it
        with torch.inference_mode():
            self.static: Dict[str, torch.Tensor] = {
                name: torch.full(shapes.get(name, (S,)), fill, dtype=dtype,
                                 device=dev)
                for name, (dtype, fill) in self.fills.items()}
        self.capturing = bool(capture) and dev.type == "cuda"
        self.pool = (torch.cuda.graph_pool_handle() if self.capturing
                     else None)
        self.graphs: Dict[Tuple[bool, bool], torch.cuda.CUDAGraph] = {}
        self.outputs: Dict[Tuple[bool, bool], Tuple[torch.Tensor, ...]] = {}

    def _block(self, sampled: bool, spec: bool):
        args = [self.static[name] for name in INPUTS]
        if spec:
            return self.engine._spec_block(sampled, self.static.get("hist"),
                                           *args)
        return self.engine._decode_block(sampled, *args)

    def load(self, name: str, array: np.ndarray) -> None:
        """One host array into its static buffer (one counted upload)."""
        self.engine._upload_into(self.static[name], array)

    def ensure(self, sampled: bool, spec: bool = False) -> None:
        """Capture the (``spec``, ``sampled``) graph if this engine has
        not yet.  Call before loading a block's inputs: capture resets
        every static buffer to the all-inactive values."""
        key = (bool(spec), bool(sampled))
        if not self.capturing or key in self.graphs:
            return
        st = self.engine.host_stats
        t0 = time.perf_counter()
        with torch.inference_mode():
            for name, (_, fill) in self.fills.items():
                self.static[name].fill_(fill)
            self.graphs[key], self.outputs[key] = capture_graph(
                lambda: self._block(sampled, spec), pool=self.pool)
        st.graph_captures += 1
        st.graph_capture_s += time.perf_counter() - t0

    def reset(self) -> None:
        """Drop every captured graph and its outputs: the engine's
        ``decode_block_size`` or ``spec_k`` changed, and a replay would
        run a block of the old shape.  The next ``ensure`` captures
        again."""
        self.graphs.clear()
        self.outputs.clear()

    def run(self, sampled: bool, spec: bool = False
            ) -> Tuple[torch.Tensor, ...]:
        """One block over the static buffers: a replay when captured, the
        same block called eagerly otherwise."""
        if not self.capturing:
            return self._block(sampled, spec)
        key = (bool(spec), bool(sampled))
        if key not in self.graphs:
            raise RuntimeError(f"no captured block for spec={spec} "
                               f"sampled={sampled}: ensure() it before the "
                               "loads")
        self.graphs[key].replay()
        self.engine.host_stats.graph_replays += 1
        return self.outputs[key]

    def chain(self, out: Tuple[torch.Tensor, ...]) -> None:
        """Copy a block's carry outputs into the static carry inputs, on
        the stream: the next block continues this one's sequences (a
        speculative block has already updated ``hist`` in place)."""
        with torch.inference_mode():
            for name, t in zip(CARRY, out):
                self.static[name].copy_(t)
