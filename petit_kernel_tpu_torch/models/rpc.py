"""Subprocess replica (torch): the Cluster router behind a real process
boundary.

Counterpart of petit_kernel_tpu/models/rpc.py. One engine runs in a child
process behind a pickle RPC pipe, the single-machine stand-in for the
transport between hosts:

  - requests and tokens cross the boundary serialized (multiprocessing.Pipe
    pickle framing), exactly the shape of a real RPC payload;
  - a child that dies (crash, kill -9) surfaces as a ReplicaError at the
    next call: genuine process-failure detection, not a simulated
    exception;
  - application errors come back as (False, repr) so the router can apply
    its transient/fatal taxonomy (models/cluster.py);
  - ``respawn()`` restarts the child with a fresh engine, which is what
    the Cluster's dead-replica re-probe uses to bring a host back.

The child builds its model from a spec instead of receiving weights over
the pipe (the deployment analog: each host loads the same weights from
storage). The spec's keys:

  cfg          LlamaConfig fields
  fmt          "bf16" (dense, served by the nvfp4 Engine as the JAX child
               does) or an FP4 format (default "bf16"; a TP replica
               quantizes, default "nvfp4")
  max_batch    the Engine's slots (default 4)
  seed         the dense weights from torch.Generator(device).manual_seed
               (default 0), made and quantized one layer at a time
               (replica_params), so the dense model never exists whole
  params_file  instead of seed: a torch.save file of a dense params tree,
               read with mmap
  device       "cuda" (the default: raises without a card, never falls
               back) or "cpu"
  tp           a TP replica of tp ranks (below)
  card         the card of rank 0 (default 0): rank r runs on card
               (card + r) modulo the host's cards

With "tp", the proxy spawns tp rank processes in a process group of their
own (NCCL on the card, gloo on the CPU, over a file store in a temporary
directory of the replica's). Each rank serves parallel.tp.
quantize_params_tp of the dense weights over its (1, tp) mesh through
Engine(forward_fn=make_tp_step, cache=init_cache_tp). Rank 0 alone holds
the pipe: it broadcasts each (method, args) to its peers over a gloo side
group, every rank runs the same Engine call in lockstep (the gathered
logits are the same bytes on every rank, so every rank's scheduler stays
in the same state), and rank 0 replies. While it waits for a reply the
proxy also watches every rank's process: a rank that exits fails the call
with a ReplicaError (fatal) instead of hanging the router, and the replica
stays lost until respawn(). crash(), respawn() and shutdown() act on every
rank: a bounded join, then terminate, then kill.

Children start with "spawn": a process that has touched CUDA is never
forked.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import shutil
import tempfile
from multiprocessing import connection
from typing import Any, Optional

import torch

from . import llama, serving

# seconds a stopping rank gets before terminate(), and again before kill()
_JOIN_S = 5.0


class ReplicaError(RuntimeError):
    """Application-level error raised inside the child engine, re-raised
    in the parent with the child's repr(exception) as the message (the
    Cluster's taxonomy classifies on this string); also a lost child."""


def _device(spec: dict, rank: int = 0) -> torch.device:
    """The device the spec's rank `rank` serves on: the CPU when asked
    for, else card (spec["card"] + rank) modulo the host's cards; raises
    without a card."""
    dev = torch.device(spec.get("device", "cuda"))
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' in the "
                           "replica's spec to serve on the CPU")
    return torch.device("cuda", (spec.get("card", 0) + rank)
                        % torch.cuda.device_count())


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def dense_params(spec: dict, device) -> dict:
    """The spec's dense weights on `device`, params["layers"] an iterator
    that makes (or reads) one dense layer at a time: from
    spec["params_file"] (mmap) when given, else from torch.Generator on
    `device` seeded with spec["seed"] (embed, final_norm and lm_head
    first, as llama.init_params of no layers makes them, then
    llama.init_layer per layer)."""
    cfg = llama.LlamaConfig(**spec["cfg"])
    if "params_file" in spec:
        tree = torch.load(spec["params_file"], mmap=True, weights_only=True)
        top = {k: _tree_to(v, device) for k, v in tree.items()
               if k != "layers"}
        return {**top, "layers": (_tree_to(lp, device)
                                  for lp in tree["layers"])}
    gen = torch.Generator(device=device).manual_seed(spec.get("seed", 0))
    top = llama.init_params(dataclasses.replace(cfg, num_layers=0), gen)
    return {**top, "layers": (llama.init_layer(cfg, gen)
                              for _ in range(cfg.num_layers))}


def replica_params(spec: dict, device=None) -> dict:
    """The params a replica without "tp" serves: dense_params, each layer
    quantized in spec["fmt"] as it is made (llama.quantize_params, fused),
    or kept dense for "bf16". On `device`, default the spec's."""
    device = _device(spec) if device is None else torch.device(device)
    fmt = spec.get("fmt", "bf16")
    dense = dense_params(spec, device)
    top = {k: v for k, v in dense.items() if k != "layers"}
    if fmt == "bf16":
        return {**top, "layers": list(dense["layers"])}
    return {**top, "layers": [
        llama.quantize_params({**top, "layers": [lp]}, fmt)["layers"][0]
        for lp in dense["layers"]]}


def _engine(spec: dict, device) -> serving.Engine:
    cfg = llama.LlamaConfig(**spec["cfg"])
    fmt = spec.get("fmt", "bf16")
    return serving.Engine(replica_params(spec, device), cfg,
                          max_batch=spec.get("max_batch", 4),
                          fmt=fmt if fmt != "bf16" else "nvfp4")


def _tp_engine(spec: dict, device) -> serving.Engine:
    """The calling rank's TP Engine over the replica's (1, tp) mesh."""
    from ..parallel import tp as tp_mod
    from .cluster import replica_meshes

    cfg = llama.LlamaConfig(**spec["cfg"])
    fmt = spec.get("fmt", "nvfp4")
    batch = spec.get("max_batch", 4)
    mesh = replica_meshes(spec["tp"], 1, device.type)[0]
    params = tp_mod.quantize_params_tp(dense_params(spec, device), cfg,
                                       mesh, fmt=fmt)
    return serving.Engine(params, cfg, max_batch=batch,
                          forward_fn=tp_mod.make_tp_step(cfg, mesh, fmt=fmt),
                          cache=tp_mod.init_cache_tp(cfg, batch, mesh))


def _replica_main(conn, spec: dict, rank: int = 0,
                  store: Optional[str] = None) -> None:
    """Child entry point: build an Engine from `spec`, serve RPC calls
    (conn: rank 0's end of the pipe; None on a TP replica's other ranks,
    which take each call from rank 0's broadcast). A TP rank first joins
    its replica's process group over the file store in `store`."""
    device = _device(spec, rank)
    if "tp" not in spec:
        _serve(conn, _engine(spec, device), None)
        return
    import torch.distributed as dist

    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device      # the communicator exists at once
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method="file://" + os.path.join(store, "store"),
        world_size=spec["tp"], rank=rank, **kw)
    try:
        # control messages ride gloo, so they never need a CUDA tensor
        ctrl = dist.new_group(backend="gloo") if spec["tp"] > 1 else None
        _serve(conn, _tp_engine(spec, device), ctrl)
    finally:
        dist.destroy_process_group()


def _next_call(conn, ctrl):
    """The next (method, args): rank 0 reads it from the pipe (("_eof",
    ()) once the router is gone) and broadcasts it over `ctrl` to the
    replica's other ranks, which return what it sent."""
    msg = None
    if conn is not None:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            msg = ("_eof", ())
    if ctrl is not None:
        import torch.distributed as dist
        box = [msg]
        dist.broadcast_object_list(box, src=0, group=ctrl)
        msg = box[0]
    return msg


def _serve(conn, eng: serving.Engine, ctrl) -> None:
    if eng.device.type == "cuda":
        # what the build cached goes back to the card, which the replicas
        # of one host may share
        torch.cuda.empty_cache()
    while True:
        method, args = _next_call(conn, ctrl)
        if method == "_eof":
            return
        if method == "shutdown":
            if conn is not None:
                conn.send((True, None))
            return
        if method == "crash":  # test hook: hard process death (no reply)
            os._exit(17)
        try:
            if method == "ping":
                val = True
            elif method == "load":
                val = int(eng.active.sum()) + len(eng._pf)
            elif method == "has_work":
                val = bool(eng.active.any() or eng._pf)
            elif method == "drain_finished":
                val = {u: eng.finished.pop(u) for u in list(eng.finished)}
            elif method == "inject_fault":
                # test hook: make the NEXT step raise `args[0]` once, as if
                # the engine hit it mid-decode (e.g. pool exhaustion)
                _arm_fault(eng, args[0])
                val = None
            else:
                val = getattr(eng, method)(*args)
            reply = (True, val)
        except Exception as e:  # noqa: BLE001 (forwarded to the router)
            reply = (False, repr(e))
        if conn is not None:
            conn.send(reply)


def _arm_fault(eng, message: str) -> None:
    orig = eng.step

    def step_once(*a, **kw):
        eng.step = orig
        raise RuntimeError(message)

    eng.step = step_once


class SubprocessReplica:
    """Engine proxy over a child process, or over a TP replica's tp rank
    processes (spec["tp"]). Implements the narrow interface the Cluster
    router uses (add_request / has_capacity / step / step_block / reset /
    load / has_work / drain_finished)."""

    def __init__(self, spec: dict, ctx: Optional[str] = "spawn"):
        _device(spec)             # no card and no "cpu": raise here
        self.spec = spec
        self._ctx = mp.get_context(ctx) if ctx else mp.get_context()
        self._procs: list = []
        self._store: Optional[str] = None
        self._lost: Optional[str] = None
        self.conn = None
        self.respawns = 0
        self._spawn()

    def _spawn(self) -> None:
        parent, child = self._ctx.Pipe(duplex=True)
        if "tp" in self.spec:
            self._store = tempfile.mkdtemp(prefix="pk_replica_")
        n = self.spec.get("tp", 1)
        self._procs = [self._ctx.Process(
            target=_replica_main, args=(child if r == 0 else None, self.spec),
            kwargs=dict(rank=r, store=self._store), daemon=True)
            for r in range(n)]
        for p in self._procs:
            p.start()
        child.close()
        self.conn = parent
        self._lost = None

    def _recv(self):
        """rank 0's reply; EOFError when any rank exits first."""
        while True:
            ready = connection.wait([self.conn]
                                    + [p.sentinel for p in self._procs])
            if self.conn in ready:
                return self.conn.recv()
            for r, p in enumerate(self._procs):
                if p.exitcode is not None:
                    raise EOFError(f"rank {r} of {len(self._procs)} exited "
                                   f"with code {p.exitcode}")

    def _call(self, method: str, *args) -> Any:
        if self._lost is not None:
            raise ReplicaError(self._lost)
        try:
            self.conn.send((method, args))
            ok, val = self._recv()
        except (EOFError, OSError) as e:   # BrokenPipeError is an OSError
            # replies still owed by live ranks must never answer a later
            # call: the replica stays lost until respawn()
            self._lost = f"replica process lost: {e!r}"
            raise ReplicaError(self._lost) from e
        if not ok:
            raise ReplicaError(val)
        return val

    # -- Cluster interface ---------------------------------------------------
    def add_request(self, req) -> int:
        return self._call("add_request", req)

    def has_capacity(self) -> bool:
        return self._call("has_capacity")

    def step(self) -> int:
        return self._call("step")

    def step_block(self, max_steps: int, waiters: bool = True) -> int:
        return self._call("step_block", max_steps, waiters)

    def reset(self) -> None:
        self._call("reset")

    def load(self) -> int:
        return self._call("load")

    def has_work(self) -> bool:
        return self._call("has_work")

    def drain_finished(self) -> dict:
        return self._call("drain_finished")

    # -- lifecycle -----------------------------------------------------------
    def _stop(self) -> None:
        """Every rank gone: a bounded join, then terminate, then kill;
        then the pipe and the file store. A dead rank frees its card's
        memory only once it has exited, so this returns after that."""
        for p in self._procs:
            p.join(timeout=_JOIN_S)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=_JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
        if self.conn is not None:
            self.conn.close()
        if self._store is not None:
            shutil.rmtree(self._store, ignore_errors=True)
            self._store = None

    def ping(self) -> bool:
        """Liveness probe; False when the child is gone (never raises)."""
        try:
            return bool(self._call("ping"))
        except ReplicaError:
            return False

    def respawn(self) -> bool:
        """Restart the child with a fresh engine (dead-replica recovery).
        Returns True when the new child answers ping."""
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        self._stop()
        self._spawn()
        self.respawns += 1
        return self.ping()

    # test hooks -----------------------------------------------------------
    def crash(self) -> None:
        """Hard-kill the child, every rank of it (no reply): simulates
        host or process loss. Rank 0 passes the call to its peers; _stop
        is the backstop."""
        try:
            self.conn.send(("crash", ()))
        except OSError:
            pass
        self._stop()

    def inject_fault(self, message: str) -> None:
        self._call("inject_fault", message)

    def shutdown(self) -> None:
        try:
            self._call("shutdown")
        except ReplicaError:
            pass
        self._stop()
