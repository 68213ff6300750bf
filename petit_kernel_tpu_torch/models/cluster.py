"""Data-parallel serving across replicas (torch): the Cluster router.

Counterpart of petit_kernel_tpu/models/cluster.py. Data parallelism
across hosts exchanges only requests and finished tokens: host-side Python,
never device collectives. So the tier is an orchestration problem, not a
kernel problem, and this module is framework code over the port's engines:

  - ``hybrid_mesh``: the (dp, tp) DeviceMesh of the calling job, ranks laid
    out row-major, so ranks r*tp .. r*tp+tp-1 form one replica's TP group
    (one host's NVLink domain, as one host's ICI domain in the JAX package).
  - ``replica_meshes``: n disjoint (1, tp) DeviceMeshes, one a replica.
  - ``make_tp_cluster``: dp TP replicas behind one router, each a
    ``rpc.SubprocessReplica`` of tp rank processes.
  - ``Cluster``: least-loaded request router over N engine replicas with
    failure detection: a replica whose step raises is marked dead and its
    in-flight requests are replayed from the prompt on the survivors
    (decode state is not migrated; KV caches live on the replica's card and
    replay is the honest recovery on a slot-based engine).

Why make_tp_cluster has no in-process form here: the JAX package builds dp
TP engines over disjoint device slices of one process (its
``make_tp_cluster`` over ``replica_meshes``), since one JAX process drives
every local device. torch.distributed gives each process exactly one rank,
and a rank runs on one card, so a replica with tp > 1 is tp processes, and
two such replicas cannot live in one process. So each replica is a process
group of its own behind one pipe (models/rpc.py): its rank 0 talks to the
router and broadcasts each call to its peers, which run it in lockstep.
The router and its logic are the JAX package's, line for line.

Determinism: greedy requests produce identical tokens whichever replica
serves them (same params, same program), so routing is free to be purely
load-based.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import weakref
from collections import deque
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from . import llama, rpc, serving


def _device_type(device_type: Optional[str]) -> str:
    """`device_type` when given, else "cuda" (raises without a card)."""
    return device_type or llama.resolve_device().type


def hybrid_mesh(dp: int, tp: int, device_type: Optional[str] = None
                ) -> DeviceMesh:
    """The (dp, tp) mesh of the calling job, dims ("dp", "tp"), ranks
    0 .. dp*tp - 1 laid out row-major: one row is one replica's TP group
    (consecutive ranks, one host's cards), the "dp" axis crosses hosts.
    Every rank of the job calls it (group creation is collective). Raises
    ValueError when dp*tp exceeds the world size."""
    world = torch.distributed.get_world_size()
    if dp * tp > world:
        raise ValueError(f"dp*tp={dp * tp} > {world} ranks")
    return DeviceMesh(_device_type(device_type),
                      torch.arange(dp * tp).reshape(dp, tp),
                      mesh_dim_names=("dp", "tp"))


def replica_meshes(tp: int, n: int, device_type: Optional[str] = None
                   ) -> list[DeviceMesh]:
    """`n` disjoint (dp=1, tp) meshes over ranks [i*tp, (i+1)*tp), one a
    DP replica. Every rank of the job calls it, since group creation is
    collective; the calling rank serves with the mesh that holds it. A
    replica's own job (make_tp_cluster) calls it with n=1."""
    world = torch.distributed.get_world_size()
    if n * tp > world:
        raise ValueError(f"need {n * tp} ranks, have {world}")
    dt = _device_type(device_type)
    return [DeviceMesh(dt, torch.arange(i * tp, (i + 1) * tp).reshape(1, tp),
                       mesh_dim_names=("dp", "tp")) for i in range(n)]


def make_tp_cluster(params, cfg: llama.LlamaConfig, *, dp: int, tp: int,
                    fmt: str = "nvfp4", max_batch: int = 4,
                    device_type: Optional[str] = None) -> "Cluster":
    """dp TP-engine replicas behind one router. Each replica is an
    rpc.SubprocessReplica of tp rank processes in a process group of its
    own (NCCL on the card, gloo for device_type "cpu"); rank r of replica i
    runs on card i*tp + r (card 0 on a one-card host) and serves
    parallel.tp.quantize_params_tp of the dense `params` over its (1, tp)
    mesh through Engine(forward_fn=make_tp_step, cache=init_cache_tp).
    The dense params are written once to a file that every rank reads with
    mmap; Cluster.shutdown() removes it (so does the collector, when the
    cluster is dropped)."""
    device = _device_type(device_type)
    tmp = tempfile.mkdtemp(prefix="pk_tp_cluster_")
    path = os.path.join(tmp, "params.pt")
    torch.save(rpc._tree_to(params, "cpu"), path)
    spec = dict(cfg=dataclasses.asdict(cfg), fmt=fmt, max_batch=max_batch,
                device=device, params_file=path, tp=tp)
    try:
        replicas = [rpc.SubprocessReplica(dict(spec, card=i * tp))
                    for i in range(dp)]
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    cl = Cluster(replicas)
    cl._files = weakref.finalize(cl, shutil.rmtree, tmp, True)
    return cl


class ReplicaFailed(RuntimeError):
    """Raised internally when a replica's step raises; carried in
    ``Cluster.failures`` for observability."""


#: substrings of exception reprs that mark a TRANSIENT fault: load or
#: resource pressure the replica survives (shed the in-flight work, keep
#: serving), as opposed to device or process loss (dead until re-probe).
#: The paged pool's exhaustion (models/paged.py) and a full engine
#: (Engine.add_request) are the port's own; "ResourceExhausted" is XLA's
#: out-of-memory error, "OutOfMemoryError" torch's (torch.cuda.
#: OutOfMemoryError), so an allocation failure on the card is transient.
TRANSIENT_MARKERS = ("pool exhausted", "no free slot", "ResourceExhausted",
                     "OutOfMemoryError")


class Cluster:
    """Least-loaded router + failure taxonomy + replay over replicas.

    Engines are ordinary ``serving.Engine`` (or Paged/Spec) instances or
    ``rpc.SubprocessReplica`` proxies: anything with add_request /
    has_capacity / step / step_block (+ optional load / has_work /
    drain_finished / reset / ping / respawn, used when present).

    Failure taxonomy (``_classify``): a TRANSIENT error (resource
    pressure, e.g. paged-pool exhaustion) sheds the replica's in-flight
    requests back to pending and resets it: the replica keeps serving.
    A FATAL error (anything else: device loss, process death) marks it
    dead; every ``probe_cooldown`` ticks dead replicas are re-probed
    (``ping``/``respawn`` for subprocess replicas, ``reset`` for
    in-process engines) and rejoin on success.
    """

    def __init__(self, replicas: list, probe_cooldown: int = 8):
        if not replicas:
            raise ValueError("Cluster needs >= 1 replica")
        self.replicas = list(replicas)
        self.alive = [True] * len(replicas)
        self.probe_cooldown = probe_cooldown
        self.cooldown = [0] * len(replicas)
        self.pending: deque = deque()
        self.assigned: dict[int, int] = {}      # uid -> replica index
        self._req: dict[int, serving.Request] = {}   # uid -> request
        self.finished: dict[int, list[int]] = {}
        self.failures: list[tuple[int, str]] = []    # (replica, why)
        self.transients: list[tuple[int, str]] = []  # (replica, why)
        self.replayed: list[int] = []                # uids replayed
        self.revived: list[int] = []                 # replica indices
        self._files = None      # make_tp_cluster's params file, if any

    # -- load accounting ---------------------------------------------------
    def load(self, i: int) -> int:
        eng = self.replicas[i]
        if hasattr(eng, "load"):
            return int(eng.load())
        return int(eng.active.sum()) + len(eng._pf)

    def _has_work(self, eng) -> bool:
        if hasattr(eng, "has_work"):
            return bool(eng.has_work())
        return bool(eng.active.any() or eng._pf)

    def _pick_replica(self) -> Optional[int]:
        best, best_load = None, None
        for i, eng in enumerate(self.replicas):
            if not self.alive[i]:
                continue
            try:  # a dead process can surface at ANY rpc, not just step
                if not eng.has_capacity():
                    continue
                ld = self.load(i)
            except Exception as e:
                self._fail(i, repr(e))
                continue
            if best_load is None or ld < best_load:
                best, best_load = i, ld
        return best

    # -- request flow ------------------------------------------------------
    def submit(self, requests: list[serving.Request]) -> None:
        for r in requests:
            if r.uid in self._req:
                raise ValueError(f"duplicate uid {r.uid}")
            self._req[r.uid] = r
            self.pending.append(r.uid)

    def _admit(self) -> None:
        while self.pending:
            i = self._pick_replica()
            if i is None:
                return
            uid = self.pending.popleft()
            try:
                self.replicas[i].add_request(self._req[uid])
            except Exception as e:
                self.pending.appendleft(uid)
                self._fail(i, repr(e))
                continue
            self.assigned[uid] = i

    def _collect(self, i: int) -> None:
        eng = self.replicas[i]
        if hasattr(eng, "drain_finished"):
            fin = eng.drain_finished()
        else:
            fin = {uid: eng.finished.pop(uid) for uid in list(eng.finished)}
        for uid, toks in fin.items():
            self.finished[uid] = toks
            self.assigned.pop(uid, None)

    # -- failure handling ----------------------------------------------------
    @staticmethod
    def _classify(why: str) -> str:
        return ("transient" if any(m in why for m in TRANSIENT_MARKERS)
                else "fatal")

    def _requeue_inflight(self, i: int) -> None:
        for uid, rep in list(self.assigned.items()):
            if rep == i:
                del self.assigned[uid]
                self.replayed.append(uid)
                self.pending.appendleft(uid)

    def _fail(self, i: int, why: str) -> None:
        """Apply the taxonomy. Transient: shed in-flight work (replayed on
        any replica, possibly this one) + reset; the replica stays alive.
        Fatal: mark dead, replay elsewhere, arm the re-probe cooldown.

        Decode state (KV cache) lives on the failing replica's card, so
        recovery restarts generation from the prompt: duplicated work,
        surfaced via ``replayed`` so operators can account for it."""
        if self._classify(why) == "transient":
            self.transients.append((i, why))
            self._requeue_inflight(i)
            try:
                self.replicas[i].reset()
                return                      # still alive
            except Exception as e:          # reset itself failed: escalate
                why = f"{why}; reset failed: {e!r}"
        self.alive[i] = False
        self.cooldown[i] = self.probe_cooldown
        self.failures.append((i, why))
        self._requeue_inflight(i)
        if not any(self.alive):
            raise ReplicaFailed(f"all replicas dead (last: {why})")

    def _probe_dead(self) -> None:
        """Re-probe dead replicas whose cooldown expired: subprocess
        replicas get ping-then-respawn, in-process engines a reset probe.
        Failed probes re-arm a doubled cooldown (bounded backoff)."""
        for i, eng in enumerate(self.replicas):
            if self.alive[i]:
                continue
            if self.cooldown[i] > 0:
                self.cooldown[i] -= 1
                continue
            ok = False
            try:
                if hasattr(eng, "ping"):
                    ok = eng.ping() or (hasattr(eng, "respawn")
                                        and eng.respawn())
                else:
                    eng.reset()
                    ok = eng.has_capacity()
            except Exception:
                ok = False
            if ok:
                self.alive[i] = True
                self.revived.append(i)
            else:
                self.cooldown[i] = min(self.cooldown[i] * 2 + 2, 64)

    def tick(self, decode_block: int = 1) -> int:
        """One cluster round: re-probe dead replicas, admit pending, tick
        every live replica (decode_block > 1 => multi-token blocks per host
        round-trip), collect finishes. Returns outstanding work count."""
        self._probe_dead()
        self._admit()
        for i, eng in enumerate(self.replicas):
            if not self.alive[i]:
                continue
            try:  # failure detection on EVERY replica interaction
                if not self._has_work(eng):
                    continue
                if decode_block > 1:
                    eng.step_block(decode_block)
                else:
                    eng.step()
                self._collect(i)
            except Exception as e:  # taxonomy: requeue + continue
                self._fail(i, repr(e))
        return len(self.pending) + len(self.assigned)

    def run(self, requests: list[serving.Request],
            decode_block: int = 1) -> dict[int, list[int]]:
        self.submit(requests)
        while self.tick(decode_block):
            pass
        return dict(self.finished)

    def shutdown(self) -> None:
        """Stop every replica that runs in a process of its own and remove
        the files make_tp_cluster wrote for them."""
        for eng in self.replicas:
            if hasattr(eng, "shutdown"):
                eng.shutdown()
        if self._files is not None:
            self._files()
