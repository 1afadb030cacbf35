"""Scale-out serving: replicated ragged engines behind an SLO-aware
router with continuous admission control.

Counterpart of ``deepspeed_tpu/serving/``, copied and adapted; it imports
nothing of the JAX package and is engine-agnostic behind the handle
protocol.  Replicas are thread-per-replica in one process: on ``cuda``
several engines share one card (each with its own KV pool and tier
store, over one module's weights when the factory passes the same
module), on the CPU they interleave on the host.  Greedy results are the
same either way.

- :class:`~.replica_set.ReplicaSet` / :class:`~.replica_set.EngineReplicaHandle`
  — N engines, each on its own single-worker thread, fed through a
  bounded window (a third instance of the
  :class:`~deepspeed_tpu_torch.utils.async_stage.BoundedAsyncStage`
  substrate, after the engine's pipelined decode carry and the NVMe
  moment stream).
- :class:`~.router.Router` — the front end: pluggable load-balancing
  policies (``rr`` / ``least_tokens`` / ``pressure``), sticky routing
  for prefix-cache affinity (prompt-prefix chain hash), and an
  admission controller (priorities, per-replica queue caps, SLO
  burn-rate shed/defer, request deadlines) with loud typed rejections.
- Fault tolerance: a per-replica liveness watchdog
  (``ReplicaSet(watchdog_s=...)`` bounds every feed/step join;
  :class:`~.replica_set.ReplicaHangError` on a wedge) under a typed
  health breaker (:class:`~.router.BreakerConfig` —
  healthy/suspect/dead/probation, hedged re-dispatch of unadmitted
  requests off suspects, revival probes through the ReplicaSet
  factory, flap freeze).
- :class:`~.server.FrontDoorServer` — the network front door: a
  stdlib-asyncio HTTP/1.1 + SSE endpoint over the router with token
  streaming at harvest granularity, client-disconnect cancellation
  that reclaims pool pages mid-decode, deadline admission, and
  SIGTERM graceful drain with warm-state handoff.
- :mod:`~.client` — asyncio SSE client + open-loop Poisson /
  closed-loop load generator measuring TTFT/TPOT at the socket.
"""
from deepspeed_tpu_torch.serving.replica_set import (EngineReplicaHandle,
                                               ReplicaHangError,
                                               ReplicaSet)
from deepspeed_tpu_torch.serving.router import (BreakerConfig,
                                          DeadlineRejection,
                                          DrainingRejection,
                                          NeverSchedulableRejection,
                                          POLICIES, QueueFullRejection,
                                          REPLICA_STATES, Router,
                                          RouterRejection, ShedRejection)

__all__ = ["ReplicaSet", "EngineReplicaHandle", "Router", "POLICIES",
           "RouterRejection", "QueueFullRejection", "ShedRejection",
           "NeverSchedulableRejection", "DeadlineRejection",
           "DrainingRejection", "FrontDoorServer", "BreakerConfig",
           "ReplicaHangError", "REPLICA_STATES"]


def __getattr__(name):
    # server/client import asyncio machinery; keep the base package
    # import light by resolving them lazily
    if name == "FrontDoorServer":
        from deepspeed_tpu_torch.serving.server import FrontDoorServer
        return FrontDoorServer
    raise AttributeError(name)
