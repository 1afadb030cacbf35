"""Rank processes for the port's multi-rank tests.

``spawn(worker, world, workdir, **kw)`` starts ``world`` processes with
``torch.multiprocessing`` (``spawn``), each calling ``worker(rank, world,
init_method, **kw)`` after ``torch.set_num_threads(1)``; they meet through
a ``file://`` rendezvous under ``workdir`` (no TCP port), and each returns
a picklable result.  The pytest process itself never initialises a
process group.  This module imports torch and the port only, so the
ranks start without JAX.
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)


def _entry(rank, world, init_method, q, worker, kw):
    torch.set_num_threads(1)
    try:
        q.put((rank, "ok", worker(rank, world, init_method, **kw)))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
    finally:
        q.close()
        q.join_thread()             # the result is in the pipe
        # an abandoned collective thread (the watchdog test) must not hold
        # the process at exit
        os._exit(0)


def spawn(worker, world: int, workdir: str, timeout: float = 240.0, **kw):
    """Run ``worker`` on ``world`` ranks; returns the results by rank."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = "file://" + tempfile.mktemp(prefix="rendezvous_", dir=workdir)
    procs = [ctx.Process(target=_entry, args=(r, world, init, q, worker, kw))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            try:
                rank, status, value = q.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"{world - len(results) - len(errors)} "
                                   f"of {world} ranks gave no result in "
                                   f"{timeout} s") from None
            if status == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


def tiny_model(remat: bool = True):
    from deepspeed_tpu_torch.models import llama

    with torch.device("meta"):
        return llama.LlamaLMLoss(llama.LlamaConfig(
            **TINY, dtype=torch.float32, param_dtype=torch.float32,
            remat=remat))


def zero_config(stage: int, lr: float = 1e-3, **zero):
    return {"train_batch_size": 8, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "steps_per_print": 100,
            "optimizer": {"type": "AdamW", "params": {
                "lr": lr, "weight_decay": 0.1, "fused": True}},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 0.0, "warmup_max_lr": lr,
                "warmup_num_steps": 5, "warmup_type": "linear"}},
            "zero_optimization": dict(
                stage=stage, stage3_param_persistence_threshold=1000,
                **zero),
            "comms_logger": {"enabled": True}}


def make_engine(state, stage: int, device: str = "cpu", remat: bool = True,
                **zero):
    import deepspeed_tpu_torch

    params = {k: torch.from_numpy(v) for k, v in state.items()}
    return deepspeed_tpu_torch.initialize(
        model=tiny_model(remat), model_parameters=params,
        config=zero_config(stage, **zero), device=device)[0]


def largest_fp32_tensor(fn):
    """``(fn(), n)``: ``n`` is the most elements of any fp32 tensor that
    an operation made or wrote whole (not a view) while ``fn`` ran, an
    upper bound on the largest fp32 buffer it held."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Track(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and not t._is_view() and
                        t.dtype == torch.float32):
                    self.most = max(self.most, t.numel())
            return out

    with Track() as track:
        result = fn()
    return result, track.most


def numpy_state(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# comm
# ---------------------------------------------------------------------------

def comm_worker(rank, world, init_method, seed, watchdog=False):
    """Every collective on seeded inputs; the logger's counts; and, with
    ``watchdog``, rank 1 dropping an all_reduce that rank 0 waits for
    under a 1 s deadline."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm.comms_logging import CommsLogger

    comm.init_distributed(device="cpu", init_method=init_method, rank=rank,
                          world_size=world)
    comm.comms_logger.enabled = True
    x = torch.from_numpy(np.random.default_rng(seed + rank).standard_normal(
        (world * 2, 3)).astype(np.float32))
    out = {"x": x.numpy().copy()}
    for op in ("sum", "avg", "max", "min"):
        out[f"all_reduce_{op}"] = comm.all_reduce(x.clone(), op=op).numpy()
    out["all_gather_0"] = comm.all_gather(x).numpy()
    out["all_gather_1"] = comm.all_gather(x, axis=1).numpy()
    out["all_gather_stack"] = comm.all_gather(x, axis=1, tiled=False).numpy()
    out["reduce_scatter_0"] = comm.reduce_scatter(x).numpy()
    out["reduce_scatter_avg"] = comm.reduce_scatter(x, op="avg").numpy()
    out["reduce_scatter_1"] = comm.reduce_scatter(
        x.t().contiguous(), axis=1).numpy()
    out["all_to_all"] = comm.all_to_all(x).numpy()
    out["all_to_all_01"] = comm.all_to_all(x, split_axis=0,
                                           concat_axis=1).numpy()
    out["broadcast"] = comm.broadcast(x.clone(), src=world - 1).numpy()
    out["ppermute"] = comm.ppermute(
        x, [(i, (i + 1) % world) for i in range(world)]).numpy()
    comm.barrier()
    out["counts"] = comm.comms_logger.counts()
    out["backend_calls"] = dict(comm.backend_calls)
    out["mean_latency_ops"] = sorted(comm.comms_logger.per_op_mean_latency())
    out["summary"] = comm.log_summary(show_straggler=True)
    out["world_size"] = comm.get_world_size()
    out["axis_index"] = comm.axis_index("data")
    out["logger_class"] = type(comm.comms_logger) is CommsLogger
    if watchdog:
        from deepspeed_tpu_torch.resilience.distributed import \
            CollectiveTimeout
        from deepspeed_tpu_torch.resilience.faults import FaultInjector

        comm.watchdog.configure(1.0)
        if rank == 1:
            with FaultInjector().drop("comm.all_reduce"):
                comm.all_reduce(x.clone())
            time.sleep(4.0)         # alive, but never joins the collective
            out["dropped"] = True
        else:
            t0 = time.perf_counter()
            try:
                comm.all_reduce(x.clone())
                out["timed_out"] = None
            except CollectiveTimeout:
                out["timed_out"] = time.perf_counter() - t0
            out["timeouts"] = comm.watchdog.get_watchdog().timeouts
    return out


# ---------------------------------------------------------------------------
# ZeRO
# ---------------------------------------------------------------------------

def _per_step(before, after, steps):
    return {k: (after[k] - before.get(k, 0)) / steps
            for k in after if after[k] != before.get(k, 0)}


def _train(eng, batches):
    """Losses, and per step the collectives logged and those that went
    through the process group, by log name."""
    from deepspeed_tpu_torch import comm

    before = comm.comms_logger.counts()
    through = dict(comm.backend_calls)
    losses = [float(eng.train_batch(batch=b)) for b in batches]
    return (losses,
            _per_step(before, comm.comms_logger.counts(), len(batches)),
            _per_step(through, dict(comm.backend_calls), len(batches)))


def zero_worker(rank, world, init_method, state, batches, cases,
                ckpt_dir=None, load_dir=None, device="cpu", drawn=False):
    """Train each ``(stage, hpz, remat)`` case over ``batches`` and report
    losses, whole weights (rank 0), buffer sizes, the plan, collective
    counts per step and the tensor_fragment getters.  With ``ckpt_dir``:
    a stage-3 run saves after 2 steps, goes on 2 more, and a fresh engine
    loads and retakes them (bit-identical).  With ``load_dir``: a stage-2
    engine loads that checkpoint and takes the last 2 steps.  With
    ``drawn``: a stage-3 engine on a meta-device model whose weights it
    draws (seed 5), the largest fp32 tensor of its init and its whole
    weights.  ``device``:
    ``cpu`` (gloo) or ``cuda`` (NCCL, ``cuda:<rank>``)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.utils import tensor_fragment as tf

    comm.init_distributed(device=device, init_method=init_method, rank=rank,
                          world_size=world)
    out = {}
    for stage, hpz, remat in cases:
        eng, init_most = largest_fp32_tensor(lambda: make_engine(
            state, stage, device=device, remat=remat,
            zero_hpz_partition_size=hpz))
        losses, per_step, backend = _train(eng, batches)
        full = numpy_state(eng.module_state_dict())
        name = "lm.model.layers.1.mlp.up_proj.weight"
        frag = {key: tf.safe_get_full_optimizer_state(eng, name, key)
                for key in ("exp_avg", "exp_avg_sq")}
        frag["param"] = tf.safe_get_full_fp32_param(eng, name)
        frag["grad"] = tf.safe_get_full_grad(eng, name)
        local = tf.safe_get_local_fp32_param(eng, name)
        flat = frag["param"].reshape(-1)
        plan = eng.plan
        out[(stage, hpz, remat)] = rec = {
            "losses": losses, "per_step": per_step, "backend": backend,
            "init_fp32_most": init_most,
            "numels": eng.buffer_numels(), "n_total": eng.num_parameters,
            "local_ok": torch.equal(local, flat)}
        if plan is not None:
            pieces = [(lo, hi) for i, lo, hi, _ in plan.leaf_pieces()
                      if eng._names[i] == name]
            rec.update(
                want_per_step=plan.step_collectives(eng.gas),
                peak_live=eng.zero.peak_live, n_shard=plan.n_shard,
                n_full=plan.n_full, n_param=plan.n_param,
                units=[(u.name, u.padded, u.persistent)
                       for u in plan.units],
                local_ok=torch.equal(local, torch.cat(
                    [flat[lo:hi] for lo, hi in pieces] + [flat[:0]])))
        rec.update({
            "state": full if rank == 0 else None,
            "frag": {k: v.cpu().numpy() for k, v in frag.items()}
            if rank == 0 else None})
        del eng
    if ckpt_dir is not None:
        eng = make_engine(state, 3, device=device)
        first = [float(eng.train_batch(batch=b)) for b in batches[:2]]
        eng.save_checkpoint(ckpt_dir, client_state={"k": 7})
        cont = [float(eng.train_batch(batch=b)) for b in batches[2:]]
        want_master = eng.state.params.clone()
        want = numpy_state(eng.module_state_dict())
        fresh = make_engine(state, 3, device=device)
        path, client = fresh.load_checkpoint(ckpt_dir)
        again = [float(fresh.train_batch(batch=b)) for b in batches[2:]]
        out["resume"] = {
            "first": first, "cont": cont, "again": again, "client": client,
            "path": os.path.basename(path),
            "bit_identical": bool(torch.equal(fresh.state.params,
                                              want_master)),
            "moments_identical": all(
                torch.equal(fresh.state.opt_state[k], v)
                for k, v in eng.state.opt_state.items()),
            "state": want if rank == 0 else None}
    if drawn:
        import deepspeed_tpu_torch

        eng, most = largest_fp32_tensor(lambda: deepspeed_tpu_torch.initialize(
            model=tiny_model(), config=zero_config(3), device=device,
            generator=torch.Generator(device).manual_seed(5))[0])
        full = numpy_state(eng.module_state_dict())     # every rank gathers
        out["drawn"] = {"most": most, "n_shard": eng.plan.n_shard,
                        "big": max(u.padded for u in eng.plan.units),
                        "state": full if rank == 0 else None}
        del eng
    if load_dir is not None:
        eng = make_engine(state, 2, device=device)
        path, client = eng.load_checkpoint(load_dir)
        again = [float(eng.train_batch(batch=b)) for b in batches[2:]]
        full = numpy_state(eng.module_state_dict())     # every rank gathers
        out["loaded"] = {"again": again, "client": client,
                         "global_steps": eng.global_steps,
                         "state": full if rank == 0 else None}
    return out
