"""Port parity: subprocess replicas (models/rpc.py), TP replicas as
process groups (cluster.make_tp_cluster) and the cluster tier's meshes
(cluster.hybrid_mesh, cluster.replica_meshes) of petit_kernel_tpu_torch,
on the CPU.

Every child is a real process, spawned: replicas serve on the CPU
(device="cpu") the tiny bf16 Llama of tests/test_cluster.py
(init_params(PRNGKey(0)) carried by convert.params_from_jax) from a
params_file, one more builds an nvfp4 model from its seed; the TP cluster's
ranks join gloo groups; the mesh job runs on four spawned gloo ranks
(tests/_torch_parallel_ranks.py). All of them start once for the file,
while this process computes the JAX references. Every child of this file
starts with a sitecustomize hook on its path that refuses any import of
jax or of the JAX package and records, at exit, which such modules the
child holds.

Tolerances: the port's replicas give the port's in-process Engine's tokens
bit for bit, and the JAX in-process Engine's on the JAX tests' prompts;
on seeded prompts (first token not 0) a stream may leave the JAX one at a
near-tie, a step where the JAX model's top-2 logit gap is below 2^-5 *
max|logits| (tests/test_torch_cluster.py's rule). The TP cluster at (dp,
tp) = (2, 2) meets the JAX test's contract, the first two tokens of every
stream the JAX make_tp_cluster's, and its streams the port's plain nvfp4
Engine's (over the unfused tree that JAX quantize_params(..., fuse=False)
makes), each under the same rule, the gap taken from that unfused model
(the JAX TP test's oracle) through the port's plain forward: on the JAX
tests' prompts request 0's first token is a one-ulp tie (254 at 1.015625
against 38 at 1.0078125 in bf16, in both packages), which the gloo ranks'
sum of two bf16 partials breaks the other way. Mesh ids are equal.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from petit_kernel_tpu.models import cluster as jcluster
from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.models import serving as jserving
from petit_kernel_tpu_torch.models import cluster as tcluster
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.models import rpc
from petit_kernel_tpu_torch.models import serving as tserving

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

CFG = jllama.LlamaConfig.tiny()
# the modules no child of the port may import
_JAX_ROOTS = ("jax", "jaxlib", "petit_kernel_tpu")

# the children's sitecustomize: refuse the JAX roots, note the start, and
# write the JAX modules the process holds at its exit
_HOOK = '''
import atexit, os, sys

_DIR = {log!r}
_ROOTS = {roots!r}


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _ROOTS:
            raise ImportError(name + " imported in a replica's process")
        return None


def _exit():
    held = sorted(m for m in sys.modules if m.split(".")[0] in _ROOTS)
    with open(os.path.join(_DIR, "%d.exit" % os.getpid()), "w") as f:
        f.write(repr(held))


sys.meta_path.insert(0, _Refuse())
open(os.path.join(_DIR, "%d.start" % os.getpid()), "w").close()
atexit.register(_exit)
'''


def _prompts(kind: str) -> list:
    if kind == "jax":
        return [np.arange(2 + i) % 50 for i in range(4)]
    rng = np.random.default_rng(4)
    return [rng.integers(1, CFG.vocab_size, size=2 + i).astype(np.int32)
            for i in range(4)]


def _reqs(mod, prompts, n, max_new=6):
    return [mod.Request(uid=i, tokens=prompts[i], max_new_tokens=max_new)
            for i in range(n)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX params and their port copies, the spawned children (two
    params_file replicas, one seed-built nvfp4 replica, the TP cluster,
    the mesh job), then the JAX references while the children start."""
    tmp = tmp_path_factory.mktemp("rpc")
    hook_dir, log_dir = tmp / "hook", tmp / "log"
    hook_dir.mkdir()
    log_dir.mkdir()
    (hook_dir / "sitecustomize.py").write_text(
        _HOOK.format(log=str(log_dir), roots=_JAX_ROOTS))
    params = jllama.init_params(CFG, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(CFG))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    path = str(tmp / "params.pt")
    torch.save(tparams, path)
    spec = dict(cfg=dataclasses.asdict(CFG), fmt="bf16", max_batch=2,
                device="cpu", params_file=path)
    seed_spec = dict(cfg=dataclasses.asdict(CFG), seed=0, fmt="nvfp4",
                     max_batch=2, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("PYTHONPATH", os.pathsep.join(
            [str(hook_dir)] + [p for p in os.environ.get(
                "PYTHONPATH", "").split(os.pathsep) if p]))
        reps = [rpc.SubprocessReplica(spec), rpc.SubprocessReplica(spec)]
        seeded = rpc.SubprocessReplica(seed_spec)
        tp_cl = tcluster.make_tp_cluster(tparams, tcfg, dp=2, tp=2,
                                         max_batch=2, device_type="cpu")
        mesh_run = ranks.start("cluster", 4, MESH_INPUTS,
                               str(tmp / "meshes"))
        # the JAX references, while the children start
        want, eng = {}, jserving.Engine(params, CFG, max_batch=8)
        for kind in ("jax", "seeded"):
            for n in (2, 3, 4):
                eng.reset()
                want[kind, n] = eng.run(_reqs(jserving, _prompts(kind), n))
        unfused = jllama.quantize_params(params, "nvfp4", fuse=False)
        jax_tp = jcluster.make_tp_cluster(params, CFG, dp=2, tp=2,
                                          max_batch=2).run(
            _reqs(jserving, _prompts("jax"), 4))
        yield dict(params=params, tparams=tparams, tcfg=tcfg, spec=spec,
                   seed_spec=seed_spec, reps=reps, seeded=seeded, tp=tp_cl,
                   mesh_run=mesh_run, want=want, jax_tp=jax_tp,
                   unfused=convert.params_from_jax(
                       jax.tree.map(np.asarray, unfused), device="cpu"),
                   log_dir=log_dir)
        for r in reps + [seeded]:
            r.shutdown()
        tp_cl.shutdown()
        ranks.finish(mesh_run)


def _tie_rule(got, want, prompts, logits_of):
    """Equal streams, or a first divergence where the reference's top-2
    logit gap (logits_of(tokens) -> last-position logits) is below 2^-5 *
    max|logits|."""
    assert sorted(got) == sorted(want)
    for uid in sorted(want):
        sj, st = want[uid], got[uid]
        assert len(st) == len(sj), uid
        diff = [i for i, (a, b) in enumerate(zip(sj, st)) if a != b]
        if not diff:
            continue
        i = diff[0]
        lg = logits_of(np.concatenate([prompts[uid],
                                       np.asarray(sj[:i], np.int32)]))
        top2 = np.sort(lg)[-2:]
        gap = float(top2[1] - top2[0])
        bound = 2 ** -5 * float(np.abs(lg).max())
        assert gap < bound, (f"request {uid} diverges at token {i} with a "
                             f"top-2 gap {gap} >= {bound}")


def _jax_logits(params):
    def logits_of(seq):
        lg, _ = jllama.forward(params, jnp.asarray(seq)[None], CFG)
        return np.asarray(lg[0, -1], np.float32)
    return logits_of


# ---------------------------------------------------------------------------
# Subprocess replicas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["jax", "seeded"])
def test_subprocess_replica_matches_inprocess(setup, kind):
    """Requests served through the pickle-RPC process boundary give the
    port's in-process engine's tokens bit for bit, and the JAX in-process
    engine's under the module's rule: the router's payloads survive
    serialization."""
    prompts = _prompts(kind)
    local = tserving.Engine(setup["tparams"], setup["tcfg"], max_batch=8)
    mine = local.run(_reqs(tserving, prompts, 3))
    cl = tcluster.Cluster(setup["reps"])
    got = cl.run(_reqs(tserving, prompts, 3))
    assert got == mine
    assert not cl.failures
    want = setup["want"][kind, 3]
    if kind == "jax":
        assert got == want
    else:
        _tie_rule(got, want, prompts, _jax_logits(setup["params"]))
    for uid, toks in got.items():
        assert all(type(t) is int for t in toks), uid


def test_seed_built_replica_matches_inprocess(setup):
    """A replica that builds its nvfp4 model from the spec's seed serves
    the tokens of an in-process Engine over rpc.replica_params of the same
    spec, bit for bit, through a one-replica Cluster each."""
    prompts = _prompts("seeded")
    spec = setup["seed_spec"]
    local = tserving.Engine(rpc.replica_params(spec), setup["tcfg"],
                            max_batch=2, fmt="nvfp4")
    want = tcluster.Cluster([local]).run(_reqs(tserving, prompts, 3))
    got = tcluster.Cluster([setup["seeded"]]).run(
        _reqs(tserving, prompts, 3))
    assert got == want


def test_subprocess_replica_crash_replay_and_respawn(setup):
    """Kill the child process mid-flight: the router sees a genuine broken
    pipe (fatal), replays the in-flight requests on the survivor, and the
    cooldown re-probe RESPAWNS the dead child, which rejoins and serves
    again; the tokens stay the in-process engine's."""
    reps = setup["reps"]
    prompts = _prompts("jax")
    cl = tcluster.Cluster(reps, probe_cooldown=1)
    cl.submit(_reqs(tserving, prompts, 4))
    cl.tick()                      # admit + first steps
    reps[0].crash()                # hard process death (kill-level)
    assert reps[0]._procs[0].exitcode == 17
    while cl.tick():
        pass
    assert dict(cl.finished) == setup["want"]["jax", 4]
    assert cl.failures and cl.failures[0][0] == 0
    assert "replica process lost" in cl.failures[0][1]
    assert cl.replayed
    assert reps[0].respawns >= 1 and 0 in cl.revived
    assert reps[0].ping()          # respawned child is healthy


def test_subprocess_transient_fault_keeps_process(setup):
    """An application-level transient error crossing the RPC boundary is
    classified transient: the child process survives, work is replayed."""
    rep = setup["reps"][1]
    pid = rep._procs[0].pid
    cl = tcluster.Cluster([rep])
    cl.submit(_reqs(tserving, _prompts("jax"), 2))
    cl.tick()
    rep.inject_fault("paged KV pool exhausted")
    while cl.tick():
        pass
    assert dict(cl.finished) == setup["want"]["jax", 2]
    assert cl.transients and not cl.failures
    assert cl.alive == [True]
    assert cl.replayed
    assert rep.respawns == 0 and rep._procs[0].pid == pid


# ---------------------------------------------------------------------------
# TP replicas as process groups
# ---------------------------------------------------------------------------

def test_tp_cluster_matches_jax_tp_cluster(setup):
    """make_tp_cluster(dp=2, tp=2) over gloo ranks: every stream's first
    two tokens are the JAX make_tp_cluster's, and the streams the port's
    plain nvfp4 Engine's, under the module's rule, on the JAX tests'
    prompts (the first) and on seeded ones (the second)."""
    tcfg, plain = setup["tcfg"], setup["unfused"]

    def logits_of(seq):
        lg, _ = tllama.forward(plain, torch.from_numpy(seq)[None], tcfg)
        return lg[0, -1].float().numpy()

    for kind in ("jax", "seeded"):
        prompts = _prompts(kind)
        cl = tcluster.Cluster(setup["tp"].replicas)
        got = cl.run(_reqs(tserving, prompts, 4))
        assert not cl.failures and cl.alive == [True, True]
        want = tserving.Engine(plain, tcfg, max_batch=8, fmt="nvfp4").run(
            _reqs(tserving, prompts, 4))
        _tie_rule(got, want, prompts, logits_of)
        if kind == "jax":
            jax_tp = setup["jax_tp"]
            _tie_rule({u: t[:2] for u, t in got.items()},
                      {u: t[:2] for u, t in jax_tp.items()}, prompts,
                      logits_of)
    assert [len(r._procs) for r in cl.replicas] == [2, 2]


def test_tp_replica_rank_death_fails_fast_and_respawns(setup):
    """A TP replica whose rank 1 dies while rank 0 cannot answer (stopped,
    as a rank blocked in a collective would be): the next call raises
    ReplicaError within seconds (the proxy watches every rank while it
    waits, not only the pipe), the replica stays lost (ping False), and
    respawn() brings every rank back to serve the same tokens."""
    rep = setup["tp"].replicas[1]
    prompts = _prompts("jax")
    before = tcluster.Cluster([rep]).run(_reqs(tserving, prompts, 2))
    rank0 = rep._procs[0].pid
    os.kill(rank0, signal.SIGSTOP)
    try:
        rep._procs[1].kill()
        rep._procs[1].join(timeout=10)
        t0 = time.perf_counter()
        with pytest.raises(rpc.ReplicaError, match="rank 1 of 2 exited"):
            rep.has_capacity()
        assert time.perf_counter() - t0 < 10
    finally:
        os.kill(rank0, signal.SIGCONT)
    assert not rep.ping()
    assert rep.respawn() and rep.respawns == 1
    assert all(p.is_alive() for p in rep._procs)
    again = tcluster.Cluster([rep]).run(_reqs(tserving, prompts, 2))
    assert again == before


def test_tp_replica_crash_reaches_every_rank(setup):
    """crash() on a TP replica: rank 0's broadcast of the call reaches its
    peer, and every rank exits with the crash code (none needed the
    backstop); the router then sees the replica as lost."""
    rep = setup["tp"].replicas[0]
    assert rep.ping()
    rep.crash()
    assert [p.exitcode for p in rep._procs] == [17, 17]
    assert not rep.ping()
    with pytest.raises(rpc.ReplicaError):
        rep.load()


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

MESH_INPUTS = {"hybrid": [(2, 2), (1, 4), (1, 2), (4, 2)],
               "replicas": [(2, 2), (1, 4), (2, 3)]}


def _ids(mesh):
    return [[d.id for d in row] for row in mesh.devices]


def test_hybrid_mesh_and_replica_meshes_match_jax(setup):
    """On four spawned gloo ranks: hybrid_mesh's rank layout is JAX
    hybrid_mesh's device-id layout over four devices ((2, 2) is [[0, 1],
    [2, 3]]), and it raises ValueError where JAX does (4 x 2 > 4);
    replica_meshes gives JAX's disjoint (1, tp) slices, each rank holds
    exactly the slice of its ids, and each slice's "tp" group sums its own
    ranks."""
    devs = jax.devices()[:4]
    res = ranks.finish(setup["mesh_run"])
    for dp, tp in MESH_INPUTS["hybrid"]:
        if dp * tp > 4:
            with pytest.raises(ValueError):
                jcluster.hybrid_mesh(dp, tp, devs)
            want = "ValueError"
        else:
            want = _ids(jcluster.hybrid_mesh(dp, tp, devs))
        for r in res:
            assert r[f"hybrid {dp}x{tp}"] == want, (dp, tp)
    assert res[0]["hybrid 2x2"] == [[0, 1], [2, 3]]
    for tp, n in MESH_INPUTS["replicas"]:
        key = f"replicas {tp}x{n}"
        if n * tp > 4:
            with pytest.raises(ValueError):
                jcluster.replica_meshes(tp, n, devs)
            assert all(r[key] == "ValueError" for r in res)
            continue
        want = [_ids(m) for m in jcluster.replica_meshes(tp, n, devs)]
        seen = set()
        for rank, r in enumerate(res):
            got = r[key]
            assert got["ids"] == want
            assert got["mine"] == [rank // tp]
            group = want[rank // tp][0]
            assert got["tp_rank"] == group.index(rank)
            assert got["tp_sum"] == sum(group)
            seen.add(rank)
        ids = [i for m in want for i in m[0]]
        assert len(ids) == len(set(ids)) == n * tp


# ---------------------------------------------------------------------------
# Imports and devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["cluster", "rpc"])
def test_cluster_modules_import_without_jax(module):
    """petit_kernel_tpu_torch.models.cluster and .rpc import neither jax
    nor the JAX package."""
    code = ("import sys; "
            f"import petit_kernel_tpu_torch.models.{module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{_JAX_ROOTS!r}]; print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_replicas_default_to_the_card(setup):
    """A spec without "device" serves on the card: without one,
    SubprocessReplica and make_tp_cluster raise before they start any
    process, and never fall back to the CPU."""
    spec = {k: v for k, v in setup["spec"].items() if k != "device"}
    if torch.cuda.is_available():
        assert rpc._device(spec).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rpc.SubprocessReplica(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rpc._replica_main(None, spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcluster.make_tp_cluster(setup["tparams"], setup["tcfg"], dp=1,
                                 tp=1)


def test_children_never_import_jax(setup):
    """Every child this file started (the replicas, the respawned one
    among them, and every rank of the TP cluster) ran the hook that refuses
    jax and the JAX package, served, and at its exit held none of their
    modules. (Last in the file: it shuts the children down.)"""
    children = setup["reps"] + [setup["seeded"]] + setup["tp"].replicas
    pids = [p.pid for rep in children for p in rep._procs]
    for rep in setup["reps"] + [setup["seeded"]]:
        assert rep.ping()
        rep.shutdown()
    setup["tp"].shutdown()
    log = setup["log_dir"]
    for pid in pids:
        assert (log / f"{pid}.start").exists(), pid
    live = [pid for rep in children for pid in [p.pid for p in rep._procs]
            if (log / f"{pid}.exit").exists()]
    assert live, "no child reached a clean exit"
    for pid in live:
        assert (log / f"{pid}.exit").read_text() == "[]", pid
