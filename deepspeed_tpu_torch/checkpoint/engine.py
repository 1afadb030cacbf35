"""Checkpoint save and load for the training engine, at any world size
and ZeRO stage.

Counterpart of ``deepspeed_tpu/checkpoint/engine.py`` (the reference's
``engine.py:3213 save_checkpoint`` / ``:2867 load_checkpoint``) with its
hardened commit protocol:

- everything is written into a ``tmp.<tag>`` staging directory and the
  tag becomes visible only through an atomic ``os.rename``; the
  ``latest`` pointer is written after that commit, also by rename;
- ``resilience.keep_last_k`` garbage-collects old tags, never the only
  one that verifies;
- a load verifies manifests and crc32s, quarantines a corrupt tag as
  ``<tag>.corrupt`` and falls back to the newest tag that verifies (an
  explicitly requested corrupt tag raises instead).

A checkpoint carries what the JAX one does: params, optimizer moments and
count, loss-scale state, step, skipped steps, the generator state (the
PRNG key's counterpart), the LR scheduler, the dataloader cursor and
``client_state``.  Every rank writes its own pieces of the partitioned
state (``sharded.py``); rank 0 writes the rest, verifies on load and
commits, and the ranks meet at barriers between.  The pieces are
addressed by leaf, so a save at (world W, stage k) loads at (W', k').
The directory must be one all ranks see.  Async save raises (ROADMAP
A5); legacy pickles, the NVMe tiers and ``zero_to_fp32`` are not ported.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.checkpoint import sharded
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.resilience.retry import retriable
from deepspeed_tpu_torch.utils.logging import log_dist, logger

EXTRA_FILE = "extra_states.pt"          # scalars + lr scheduler + client
META_FILE = "ds_meta.json"
LATEST_FILE = "latest"
STAGING_PREFIX = "tmp."                 # uncommitted tag being written
CORRUPT_SUFFIX = ".corrupt"             # quarantined tag


def _tag_of(engine, tag: Optional[str]) -> str:
    return tag if tag is not None else f"global_step{engine.global_steps}"


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[Dict] = None,
                    save_latest: bool = True,
                    async_save: Optional[bool] = None) -> str:
    """Write the engine's state as ``<save_dir>/<tag>`` through the staging
    directory and commit it; returns the tag's path."""
    if async_save is None:
        async_save = engine.config.checkpoint.async_save
    if async_save:
        raise NotImplementedError(
            "async checkpoint save is not ported yet: ROADMAP A5")
    tag = _tag_of(engine, tag)
    path = os.path.join(save_dir, tag)
    stage = os.path.join(save_dir, STAGING_PREFIX + tag)
    rank, world = comm.get_rank(), comm.get_process_count()
    if rank == 0:
        if os.path.isdir(stage):             # leftover of a crashed save
            shutil.rmtree(stage, ignore_errors=True)
        os.makedirs(stage)
    comm.barrier()
    sharded.save_pieces(engine.checkpoint_pieces(), stage, proc=rank)
    comm.barrier()
    if rank == 0:
        st = engine.state
        extra = {
            "loss_scale": {k: v.item() for k, v in
                           dataclasses.asdict(st.scale).items()},
            "step": int(st.step),
            "rng": st.generator.get_state(),
            "skipped_steps": int(st.skipped_steps),
            "lr_scheduler": engine.lr_scheduler.state_dict(),
            "global_steps": engine.global_steps,
            "global_samples": engine.global_samples,
            "client_state": client_state or {},
        }
        dl = engine.training_dataloader
        if dl is not None and callable(getattr(dl, "state_dict", None)):
            dl_state = dl.state_dict()
            if dl_state is not None:
                extra["dataloader"] = dl_state
        meta = {"tag": tag, "format": "sharded-v2",
                "zero_stage": engine.zero_stage,
                "world_size": engine.dp_world_size, "process_count": world,
                "dtype": str(engine.compute_dtype).removeprefix("torch.")}
        _write_pickle(os.path.join(stage, EXTRA_FILE), extra)
        _write_json(os.path.join(stage, META_FILE), meta)
        _commit_tag(save_dir, tag, save_latest=save_latest,
                    keep_last_k=engine.config.resilience.keep_last_k,
                    process_count=world)
        log_dist(f"saved checkpoint {path}", ranks=[0])
    comm.barrier()
    return path


@retriable(retry_on=(OSError,))
def _write_pickle(path: str, obj) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)
        sharded._fsync_file(f)


@retriable(retry_on=(OSError,))
def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
        sharded._fsync_file(f)


def _write_latest(save_dir: str, tag: str) -> None:
    tmp = os.path.join(save_dir, LATEST_FILE + ".tmp")
    with open(tmp, "w") as f:
        f.write(tag)
        sharded._fsync_file(f)
    os.replace(tmp, os.path.join(save_dir, LATEST_FILE))


def _commit_tag(save_dir: str, tag: str, save_latest: bool,
                keep_last_k: int, process_count: int = 1) -> None:
    """Atomically publish ``tmp.<tag>`` as ``<tag>``, then point
    ``latest`` at it and garbage-collect old tags."""
    stage = os.path.join(save_dir, STAGING_PREFIX + tag)
    final = os.path.join(save_dir, tag)
    if not sharded.is_complete(stage, process_count):
        raise RuntimeError(f"commit of {tag!r}: the shards were not all "
                           "written")
    if os.path.isdir(final):
        # re-saving an existing tag replaces it (not crash-atomic for the
        # overwrite; new-tag saves, the training-loop path, are)
        shutil.rmtree(final)
    faults.hook("ckpt.commit", path=final)
    os.rename(stage, final)
    sharded.fsync_dir(save_dir)
    if save_latest:
        # after the commit and by rename: never names a missing tag
        _write_latest(save_dir, tag)
    if keep_last_k > 0:
        _gc_tags(save_dir, keep_last_k)


def _committed_tags(ckpt_dir: str) -> List[str]:
    """Committed tag names under ``ckpt_dir``, newest first (staging and
    quarantined tags excluded)."""
    out = []
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    for name in names:
        if name.startswith(STAGING_PREFIX) or CORRUPT_SUFFIX in name:
            continue
        p = os.path.join(ckpt_dir, name)
        if os.path.isdir(p) and os.path.exists(os.path.join(p, EXTRA_FILE)):
            out.append((os.stat(p).st_mtime_ns, name))
    return [name for _, name in sorted(out, reverse=True)]


def _gc_tags(ckpt_dir: str, keep_last_k: int) -> None:
    """Delete committed tags beyond the newest ``keep_last_k``, but never
    the only structurally verified tag."""
    tags = _committed_tags(ckpt_dir)
    keep, candidates = tags[:keep_last_k], tags[keep_last_k:]

    def ok(name):
        return sharded.verify_tag(os.path.join(ckpt_dir, name),
                                  deep=False)[0]

    survivor_verified = any(ok(t) for t in keep)
    for t in candidates:
        if not survivor_verified and ok(t):
            survivor_verified = True
            continue                         # spared: the only good tag
        shutil.rmtree(os.path.join(ckpt_dir, t), ignore_errors=True)
        logger.info(f"checkpoint GC: removed old tag {t!r} "
                    f"(keep_last_k={keep_last_k})")


def _quarantine_tag(ckpt_dir: str, tag: str, reason: str) -> str:
    """Move a corrupt tag aside as ``<tag>.corrupt`` (kept for a
    postmortem) and return the new path."""
    src = os.path.join(ckpt_dir, tag)
    dst = src + CORRUPT_SUFFIX
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{src}{CORRUPT_SUFFIX}.{n}"
    os.rename(src, dst)
    logger.error(f"checkpoint {tag!r} FAILED verification ({reason}); "
                 f"quarantined to {os.path.basename(dst)}")
    return dst


def _resolve_verified_tag(engine, load_dir: str, tag: Optional[str]
                          ) -> Optional[str]:
    """Resolve ``latest`` (or the newest committed tag when the pointer is
    gone), verify, quarantine corrupt tags and fall back to the newest
    tag that verifies.  A corrupt tag asked for by name raises."""
    explicit = tag is not None
    verify = engine.config.resilience.verify_on_load
    if tag is None:
        latest = os.path.join(load_dir, LATEST_FILE)
        if os.path.exists(latest):
            with open(latest) as f:
                tag = f.read().strip()
        else:
            committed = _committed_tags(load_dir)
            if not committed:
                logger.warning(f"no 'latest' file in {load_dir}; "
                               "nothing loaded")
                return None
            tag = committed[0]
            logger.warning(f"no 'latest' pointer in {load_dir}; using "
                           f"newest committed tag {tag!r}")
    tried = set()
    while True:
        tried.add(tag)
        path = os.path.join(load_dir, tag)
        if not os.path.exists(os.path.join(path, EXTRA_FILE)):
            if explicit or not os.path.isdir(path):
                logger.warning(f"checkpoint {path} missing; nothing loaded")
                return None
            ok, reason = False, "no extra_states (interrupted save?)"
        elif verify:
            ok, reason = sharded.verify_tag(
                path, process_count=_process_count(path), deep=True)
        else:
            ok, reason = True, "ok"
        if ok:
            return tag
        _quarantine_tag(load_dir, tag, reason)
        if explicit:
            raise RuntimeError(
                f"checkpoint {path} failed verification ({reason}) and was "
                "quarantined; pass tag=None to fall back to the newest "
                "verified tag")
        remaining = [t for t in _committed_tags(load_dir) if t not in tried]
        if not remaining:
            logger.warning(f"no verified checkpoint remains in {load_dir}; "
                           "nothing loaded")
            return None
        tag = remaining[0]
        logger.warning(f"falling back to tag {tag!r}")


def _process_count(path: str) -> Optional[int]:
    """How many processes wrote the tag (its meta), or None if unknown."""
    try:
        with open(os.path.join(path, META_FILE)) as f:
            return int(json.load(f).get("process_count", 1))
    except (OSError, ValueError):
        return None


def _resolve_on_rank0(engine, load_dir: str, tag: Optional[str]
                      ) -> Optional[str]:
    """Rank 0 resolves, verifies and (on a fault) quarantines; every rank
    gets its answer, or the error it raised."""
    answer = None
    if comm.get_rank() == 0:
        try:
            answer = ("ok", _resolve_verified_tag(engine, load_dir, tag))
        except (RuntimeError, OSError) as e:
            answer = ("error", f"{type(e).__name__}: {e}")
    answer = comm.broadcast_object(answer)
    if answer[0] == "error":
        raise RuntimeError(answer[1])
    return answer[1]


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    load_lr_scheduler_states: bool = True
                    ) -> Tuple[Optional[str], Optional[Dict]]:
    """Restore the engine from ``<load_dir>/<tag>`` (default: ``latest``
    with verify-quarantine-fallback).  Returns ``(path, client_state)``,
    or ``(None, None)`` when nothing verified."""
    requested = tag
    tag = _resolve_on_rank0(engine, load_dir, tag)
    if tag is None:
        return None, None
    path = os.path.join(load_dir, tag)
    if not sharded.is_complete(path, _process_count(path) or 1):
        raise RuntimeError(f"checkpoint {path} is incomplete")
    if requested is None and comm.get_rank() == 0:
        latest = os.path.join(load_dir, LATEST_FILE)
        stale = True
        if os.path.exists(latest):
            with open(latest) as f:
                stale = f.read().strip() != tag
        if stale:       # a fallback landed elsewhere: repoint the pointer
            try:
                _write_latest(load_dir, tag)
            except OSError:
                pass    # read-only checkpoint mount
    with open(os.path.join(path, EXTRA_FILE), "rb") as f:
        extra = pickle.load(f)
    pieces = engine.checkpoint_pieces(for_load=True)
    if not load_optimizer_states:
        pieces = [p for p in pieces if p[0].startswith("module/")]
    sharded.load_pieces(pieces, path)
    st = engine.state
    for name, val in extra["loss_scale"].items():
        getattr(st.scale, name).fill_(val)
    st.step = int(extra["step"])
    st.generator.set_state(extra["rng"])
    st.skipped_steps.fill_(int(extra["skipped_steps"]))
    engine.global_steps = int(extra["global_steps"])
    engine.global_samples = int(extra.get("global_samples", 0))
    engine.refresh_working_copy()
    if load_lr_scheduler_states and engine.lr_scheduler is not None:
        engine.lr_scheduler.load_state_dict(extra["lr_scheduler"])
    dl_state = extra.get("dataloader")
    dl = engine.training_dataloader
    if dl_state is not None and dl is not None and \
            callable(getattr(dl, "load_state_dict", None)):
        dl.load_state_dict(dl_state)
        engine._data_iter = None          # re-enter at the restored cursor
    log_dist(f"loaded checkpoint {path} (global_steps="
             f"{engine.global_steps})", ranks=[0])
    return path, extra.get("client_state")

