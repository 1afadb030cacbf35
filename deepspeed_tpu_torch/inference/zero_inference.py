"""ZeRO-Inference's NVMe tier: stream each layer's weights from NVMe.

Counterpart of ``deepspeed_tpu/inference/zero_inference.py`` (the
reference's ``runtime/swap_tensor/partitioned_param_swapper.py`` feeding
stage-3 inference): a Llama-family model whose weights outgrow the card
generates by streaming every decoder layer's weights from NVMe through
the card, once a forward.

- :class:`NvmeWeightStore` writes each layer to one file (every tensor
  at a 4096-byte aligned offset, in the serving dtype) through the
  native async I/O engine (``io/aio.py``) and reads it back whole into a
  page-locked host slot.
- :class:`NvmeWeightStreamingEngine` keeps only the resident tree (the
  embedding, the final norm and the LM head) on the card, plus two layer
  slots: two ``LlamaBlock`` modules whose parameters are views of one
  flat device buffer each.  While layer ``i`` runs in one slot, layer
  ``i + 1`` is copied into the other from its host slot on a copy
  stream, and layer ``i + 2`` is read from NVMe into the host slot that
  layer ``i`` came from; the last layers of a forward read the next
  forward's first.  Card residency: the resident tree plus two layers.

A model on the meta device with no ``params`` is drawn one module at a
time on the card, in ``modules()`` order from ``generator`` (the weights
the v1 engine draws for it), and each layer goes to NVMe as soon as it is
drawn, so the whole model never sits on the card.  The forward is the v1
engine's, op for op (the prefill through the flash kernel #1, decode over
fixed caches), so a streamed greedy generate gives v1's tokens.  Every
forward pays one sweep of the layer weights from NVMe: the reference's
economics, amortized by batching.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from deepspeed_tpu_torch.accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.inference.kv_cache import init_cache
from deepspeed_tpu_torch.inference.sampling import sample_logits
from deepspeed_tpu_torch.runtime.swap_tensor import PAGE, host_buffer
from deepspeed_tpu_torch.utils.logging import log_dist

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "float32": torch.float32, "fp32": torch.float32}


def _layout(tensors: Mapping[str, torch.Tensor]
            ) -> Tuple[List[Tuple[str, tuple, torch.dtype, int]], int]:
    """``([(name, shape, dtype, byte offset)], bytes)`` of one layer's
    file: each tensor at a 4096-byte aligned offset."""
    out, off = [], 0
    for name, t in tensors.items():
        out.append((name, tuple(t.shape), t.dtype, off))
        off += -(-t.numel() * t.element_size() // PAGE) * PAGE
    return out, off


class NvmeWeightStore:
    """The decoder layers' weights on NVMe, one file a layer, read whole
    into a host slot with the async I/O engine."""

    def __init__(self, nvme_path: str, n_layers: int,
                 aio_block_size: int = 1 << 20, aio_thread_count: int = 8,
                 aio_queue_depth: int = 64, aio_use_odirect: bool = False):
        from deepspeed_tpu_torch.io.aio import aio_handle

        os.makedirs(nvme_path, exist_ok=True)
        self.dir = nvme_path
        self.n_layers = n_layers
        self.handle = aio_handle(block_size=aio_block_size,
                                 thread_count=aio_thread_count,
                                 queue_depth=aio_queue_depth,
                                 use_odirect=aio_use_odirect)
        self.layout: Optional[List] = None
        self.layer_bytes = 0
        self.bytes_written = 0

    def fname(self, i: int) -> str:
        return os.path.join(self.dir, f"layer_{i:04d}.bin")

    def write_layer(self, i: int, tensors: Mapping[str, torch.Tensor],
                    buf: torch.Tensor) -> None:
        """Layer ``i``'s tensors (any device, the serving dtype) through
        the host buffer ``buf`` to its file.  Every layer must have the
        first one's layout (streaming needs a uniform block)."""
        layout, nbytes = _layout(tensors)
        if self.layout is None:
            self.layout, self.layer_bytes = layout, nbytes
        elif [x[:3] for x in layout] != [x[:3] for x in self.layout]:
            raise ValueError(f"layer {i}'s weights differ in layout from "
                             "layer 0's: streaming needs a uniform block")
        for (name, shape, dtype, off), t in zip(layout, tensors.values()):
            n = t.numel() * t.element_size()
            buf[off:off + n].view(dtype).copy_(t.reshape(-1))
        self.handle.sync_pwrite(buf[:nbytes].numpy(), self.fname(i))
        self.bytes_written += nbytes

    def start_read(self, i: int, buf: torch.Tensor) -> int:
        return self.handle.async_pread(buf[:self.layer_bytes].numpy(),
                                       self.fname(i))

    def close(self) -> None:
        self.handle.close()


class NvmeWeightStreamingEngine:
    """Greedy generation with the decoder layers' weights on NVMe.

    ``model``: a Llama-family ``*ForCausalLM`` of this package (meta or
    real weights); ``params``: a ``state_dict`` of it (any device and
    dtype), or None for the model's own weights (drawn from
    ``generator`` when it is on the meta device).  ``dtype``: the serving
    dtype (the model config's by default).  ``device``: ``cuda`` by
    default; the CPU only when asked for."""

    def __init__(self, model: nn.Module,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 nvme_path: str = "", max_batch_size: int = 8,
                 max_out_tokens: int = 256, dtype=None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 aio_block_size: int = 1 << 20, aio_thread_count: int = 8,
                 aio_queue_depth: int = 64, aio_use_odirect: bool = False):
        mcfg = getattr(model, "config", None)
        if not (hasattr(mcfg, "rope_theta") and hasattr(model, "model") and
                hasattr(model.model, "layers")):
            raise TypeError("NVMe weight streaming serves the Llama family "
                            "(models/llama.py)")
        if not nvme_path:
            raise ValueError("NVMe weight streaming needs an nvme_path")
        self.device = resolve_device(device)
        self.dtype = (_DTYPES[dtype] if isinstance(dtype, str) else
                      dtype or mcfg.dtype)
        self.cfg = mcfg
        self.lm = model
        self.max_batch_size = max_batch_size
        self.max_out_tokens = max_out_tokens
        layers = model.model.layers
        L = len(layers)
        self.store = NvmeWeightStore(nvme_path, L,
                                     aio_block_size=aio_block_size,
                                     aio_thread_count=aio_thread_count,
                                     aio_queue_depth=aio_queue_depth,
                                     aio_use_odirect=aio_use_odirect)
        self._owners: list = []
        t0 = time.perf_counter()
        self._place(model, params, generator)
        self.write_seconds = time.perf_counter() - t0
        # two layer slots on the card and two page-locked host slots
        nbytes = self.store.layer_bytes
        self._hbuf = [host_buffer(nbytes, torch.uint8, self.device,
                                  zero=False, owners=self._owners)
                      for _ in range(2)]
        self._dbuf = [torch.empty(nbytes, dtype=torch.uint8,
                                  device=self.device) for _ in range(2)]
        with torch.device("meta"):
            blocks = [type(layers[0])(mcfg) for _ in range(2)]
        for blk, dbuf in zip(blocks, self._dbuf):
            for name, shape, dt, off in self.store.layout:
                mod_name, _, attr = name.rpartition(".")
                n = torch.Size(shape).numel() * torch.empty(
                    (), dtype=dt).element_size()
                setattr(blk.get_submodule(mod_name), attr, nn.Parameter(
                    dbuf[off:off + n].view(dt).view(shape),
                    requires_grad=False))
        self.blocks = [b.eval() for b in blocks]
        cuda = self.device.type == "cuda"
        self._copy = torch.cuda.Stream(self.device) if cuda else None
        if cuda:
            # the layer slots may reuse blocks that queued kernels use
            self._copy.wait_stream(torch.cuda.current_stream(self.device))

        def events():
            return [torch.cuda.Event() if cuda else None for _ in range(2)]

        self._h2d_done, self._compute_done = events(), events()
        self._reads: Dict[int, Tuple[int, int]] = {}   # slot -> (layer, op)
        self._next_slot = 0
        self.stats = {"bytes_read": 0, "read_wait_s": 0.0, "sweeps": 0}
        log_dist(f"ZeRO-Inference: {L} layers of {nbytes / 1e6:.1f} MB on "
                 f"NVMe at {nvme_path} ({self.store.bytes_written / 1e9:.2f}"
                 f" GB written in {self.write_seconds:.1f} s); "
                 f"{self.resident_bytes() / 1e9:.3f} GB resident on "
                 f"{self.device}", ranks=[0])

    # -- building ------------------------------------------------------------

    def _place(self, model: nn.Module, params, generator) -> None:
        """The resident modules on the card in the serving dtype, every
        layer in its file; the layers' modules go back to meta."""
        layers = model.model.layers
        layer_of = {id(m): i for i, blk in enumerate(layers)
                    for m in blk.modules()}
        meta = any(p.is_meta for p in model.parameters())
        if meta:
            model.to(dtype=self.dtype)          # on meta: no memory touched
        state = None if params is None else dict(params)
        staging = []

        def flush(i: int) -> None:
            # layer i to its file through one page-locked staging buffer
            tensors = {n: (p if state is None else
                           state[f"model.layers.{i}.{n}"]).detach().to(
                               self.dtype)
                       for n, p in layers[i].named_parameters()}
            if not staging:
                staging.append(host_buffer(_layout(tensors)[1], torch.uint8,
                                           self.device, zero=False,
                                           owners=self._owners))
            self.store.write_layer(i, tensors, staging[0])
            layers[i].to("meta")

        if meta and params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            current = None
            with torch.no_grad():
                for mod in model.modules():
                    i = layer_of.get(id(mod))
                    if current is not None and i != current:
                        flush(current)
                    mod.to_empty(device=self.device, recurse=False)
                    model.init_module_weights(mod, generator)
                    current = i
                if current is not None:
                    flush(current)
        else:
            with torch.no_grad():
                for i in range(len(layers)):
                    flush(i)
                for name, mod in model.named_modules():
                    if id(mod) in layer_of or not list(
                            mod.parameters(recurse=False)):
                        continue
                    if meta:
                        mod.to_empty(device=self.device, recurse=False)
                    for attr, p in mod.named_parameters(recurse=False):
                        src = (state[f"{name}.{attr}"] if state is not None
                               else p)
                        setattr(mod, attr, nn.Parameter(
                            src.detach().to(self.device, self.dtype),
                            requires_grad=False))
        self._owners.clear()                 # the staging buffer goes
        model.eval()

    # -- the streamed forward ------------------------------------------------

    def _issue(self, layer: int, slot: int) -> None:
        """Start layer ``layer``'s NVMe read into host slot ``slot``,
        once the slot's last copy to the card is done."""
        ev = self._h2d_done[slot]
        if ev is not None:
            ev.synchronize()
        self._reads[slot] = (layer, self.store.start_read(layer,
                                                         self._hbuf[slot]))

    def _to_card(self, layer: int, slot: int) -> None:
        """Layer ``layer`` (read into host slot ``slot``) into card slot
        ``slot``, after that slot's previous layer has run."""
        if self._reads.get(slot, (None,))[0] != layer:
            self._issue(layer, slot)
        _, op = self._reads.pop(slot)
        t0 = time.perf_counter()
        self.store.handle.wait(op)
        self.stats["read_wait_s"] += time.perf_counter() - t0
        self.stats["bytes_read"] += self.store.layer_bytes
        n = self.store.layer_bytes
        if self._copy is None:
            self._dbuf[slot].copy_(self._hbuf[slot][:n])
            return
        with torch.cuda.stream(self._copy):
            self._copy.wait_event(self._compute_done[slot])
            self._dbuf[slot].copy_(self._hbuf[slot][:n], non_blocking=True)
            self._h2d_done[slot].record(self._copy)

    def _forward(self, ids: torch.Tensor, positions: torch.Tensor, caches,
                 prefetch: bool) -> torch.Tensor:
        """The v1 engine's forward with each layer streamed in; with
        ``prefetch`` the next forward's first layer is read at the end."""
        L = self.store.n_layers
        base = self.lm.model
        s0 = self._next_slot
        self._to_card(0, s0)
        if L > 1:
            self._issue(1, 1 - s0)
        rope = base.rope(positions)
        x = base.embed_tokens(ids)
        cur = torch.cuda.current_stream(self.device) if self._copy else None
        for i in range(L):
            s = (s0 + i) % 2
            if cur is not None:
                cur.wait_event(self._h2d_done[s])
            x = self.blocks[s](x, positions, rope, caches[i])
            if cur is not None:
                self._compute_done[s].record(cur)
            if i + 1 < L:
                self._to_card(i + 1, 1 - s)
                nxt = i + 2 if i + 2 < L else (0 if prefetch else None)
                if nxt is not None:
                    self._issue(nxt, s)
        self._next_slot = (s0 + L) % 2
        self.stats["sweeps"] += 1
        return self.lm.lm_head(base.norm(x))

    # -- public API ----------------------------------------------------------

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None) -> torch.Tensor:
        """Greedy generation, one weight sweep a token: the prefill, then
        one decode step a new token (the v1 engine's steps); it stops
        early once every row has emitted ``eos_token_id``.  Returns
        ``[B, P + new]`` token ids (int64, on the CPU)."""
        prompt = torch.as_tensor(input_ids, dtype=torch.long).to(self.device)
        B, P = prompt.shape
        if B > self.max_batch_size:
            raise ValueError(f"batch {B} exceeds max_batch_size "
                             f"{self.max_batch_size}")
        if P + max_new_tokens > self.max_out_tokens:
            raise ValueError(f"prompt {P} + max_new_tokens {max_new_tokens} "
                             f"exceeds max_out_tokens {self.max_out_tokens}")
        cfg = self.cfg
        T = P + max_new_tokens
        caches = init_cache(self.store.n_layers, T, B,
                            cfg.num_key_value_heads, cfg.head_dim,
                            self.dtype, self.device, fixed=True)
        out = self._forward(prompt, torch.arange(P, device=self.device),
                            caches, prefetch=max_new_tokens > 1)
        tok = sample_logits(out[:, -1])
        seq = torch.zeros(B, T, dtype=torch.long, device=self.device)
        seq[:, :P] = prompt
        seq[:, P] = tok
        pos = torch.full((1,), P, dtype=torch.long, device=self.device)
        eos = torch.full((1,), -1 if eos_token_id is None else eos_token_id,
                         dtype=torch.long, device=self.device)
        done = tok == eos
        n = P + 1
        for t in range(max_new_tokens - 1):
            if eos_token_id is not None and bool(done.all()):
                break
            out = self._forward(tok[:, None], pos, caches,
                                prefetch=t < max_new_tokens - 2)
            nxt = torch.where(done, eos, sample_logits(out[:, -1]))
            done |= nxt == eos
            seq.index_copy_(1, pos + 1, nxt[:, None])
            tok = nxt
            pos += 1
            n += 1
        return seq[:, :n].cpu()

    def resident_bytes(self) -> int:
        """Bytes of weights on the card: the resident tree and the two
        layer slots."""
        tree = sum(p.numel() * p.element_size()
                   for n, p in self.lm.named_parameters()
                   if not p.is_meta)
        return tree + sum(b.numel() for b in self._dbuf)

    def close(self) -> None:
        self._reads.clear()
        self.store.close()
        self._owners = []
