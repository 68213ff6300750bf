"""Port parity: the Cluster router of petit_kernel_tpu_torch
(models/cluster.py) against petit_kernel_tpu's, in process, on the CPU.

Every scenario of tests/test_cluster.py runs twice over the same tiny bf16
Llama (init_params(PRNGKey(0)), carried by convert.params_from_jax): once
through the JAX Cluster over JAX Engines, once through the port's Cluster
over port Engines, with the same faults injected at the same ticks. Each
runs on the JAX tests' prompts (np.arange(2 + i) % 50, which start with
token 0) and on seeded prompts whose tokens are drawn from [1, vocab).

The checks:
  - the bookkeeping is the JAX router's: `assigned` after the first tick,
    the replica indices of `failures` and `transients`, `replayed` (uids,
    in order), `revived` and `alive`;
  - the port Cluster's `finished` equals the port's single
    Engine(max_batch=8) on the same requests bit for bit (routing changes
    no token);
  - against the JAX Cluster's `finished`: equal on the JAX tests' prompts;
    on the seeded prompts equal, or a stream's first divergence lies at a
    near-tie, a step where the JAX model's top-2 logit gap is below 2^-5 *
    max|logits| (tests/test_torch_serving.py's rule; the seeded prompts
    part two streams at exact bf16 ties, gap 0).

JAX engines are built once per max_batch and reused through reset(), as
the JAX Engine's docstring intends (its jitted closures are per instance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import cluster as jcluster
from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.models import serving as jserving
from petit_kernel_tpu_torch.models import cluster as tcluster
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.models import serving as tserving

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

MAX_NEW = 6


def _prompts(kind: str) -> list:
    if kind == "jax":
        return [np.arange(2 + i) % 50 for i in range(6)]
    rng = np.random.default_rng(3)
    return [rng.integers(1, 512, size=2 + i).astype(np.int32)
            for i in range(6)]


@pytest.fixture(scope="module")
def models():
    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(cfg))
    pool = {}

    def jax_engines(b, n):
        """n JAX Engines of max_batch b, reset, without injected steps."""
        have = pool.setdefault(b, [])
        while len(have) < n:
            have.append(jserving.Engine(params, cfg, max_batch=b))
        for e in have[:n]:
            e.__dict__.pop("step", None)
            e.reset()
        return have[:n]

    return dict(cfg=cfg, params=params, tcfg=tcfg, tparams=tparams,
                jax_engines=jax_engines)


class _Pkg:
    """One package's serving and cluster modules, its params and engines."""

    def __init__(self, serving, cluster, make):
        self.serving, self.cluster, self._make = serving, cluster, make

    def engines(self, b, n=1):
        return self._make(b, n)

    def reqs(self, prompts, n):
        return [self.serving.Request(uid=i, tokens=prompts[i],
                                     max_new_tokens=MAX_NEW)
                for i in range(n)]


def _pkgs(models):
    port = _Pkg(tserving, tcluster, lambda b, n: [
        tserving.Engine(models["tparams"], models["tcfg"], max_batch=b)
        for _ in range(n)])
    return _Pkg(jserving, jcluster, models["jax_engines"]), port


def _fail_at(eng, ticks, exc):
    """eng.step raises exc() at the ticks `ticks(n)` is true for."""
    n = {"n": 0}
    orig = eng.step

    def step():
        n["n"] += 1
        if ticks(n["n"]):
            raise exc()
        return orig()

    eng.step = step


def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                       "allocate 2.00 GiB")


def _scenario(pkg, name, prompts, port):
    """Run tests/test_cluster.py's scenario `name`; returns the cluster's
    outputs and bookkeeping."""
    C, reqs = pkg.cluster, lambda n: pkg.reqs(prompts, n)
    first, got = None, None
    if name == "matches_single_engine":
        cl = C.Cluster(pkg.engines(2, 2))
        got = cl.run(reqs(5))
    elif name == "balances_load":
        cl = C.Cluster(pkg.engines(2, 2))
        cl.submit(reqs(4))
        cl.tick()
        first = dict(cl.assigned)
        while cl.tick():
            pass
        got = dict(cl.finished)
    elif name == "decode_block":
        cl = C.Cluster(pkg.engines(3, 2))
        got = cl.run(reqs(5), decode_block=4)
    elif name == "failure_replays":
        bad, good = pkg.engines(2, 2)
        _fail_at(bad, lambda n: n >= 3,
                 lambda: RuntimeError("injected device loss"))
        cl = C.Cluster([bad, good])
        got = cl.run(reqs(4))
    elif name == "all_dead_raises":
        bad, = pkg.engines(2)
        _fail_at(bad, lambda n: True, lambda: RuntimeError("gone"))
        cl = C.Cluster([bad])
        with pytest.raises(C.ReplicaFailed):
            cl.run(reqs(1))
    elif name in ("transient_keeps_replica", "out_of_memory_is_transient"):
        eng, = pkg.engines(4)
        # XLA's out-of-memory error on the JAX side, torch's on the port's
        exc = (_oom if port else lambda: RuntimeError(
            "ResourceExhausted: out of memory")) \
            if name == "out_of_memory_is_transient" \
            else lambda: RuntimeError("paged KV pool exhausted")
        _fail_at(eng, lambda n: n == 3, exc)
        cl = C.Cluster([eng])
        got = cl.run(reqs(4))
    elif name == "reprobe_revives":
        eng, good = pkg.engines(2, 2)
        _fail_at(eng, lambda n: n == 2, lambda: RuntimeError("device lost"))
        cl = C.Cluster([eng, good], probe_cooldown=2)
        got = cl.run(reqs(6))
    else:
        raise KeyError(name)
    return dict(
        got=got, first=first, failures=[i for i, _ in cl.failures],
        transients=[i for i, _ in cl.transients], replayed=list(cl.replayed),
        revived=list(cl.revived), alive=list(cl.alive),
        whys=[w for _, w in cl.failures + cl.transients])


# what tests/test_cluster.py asserts of each scenario, beyond the tokens
EXPECT = {
    "matches_single_engine": lambda r: not r["failures"]
    and not r["replayed"],
    "balances_load": lambda r: set(r["first"].values()) == {0, 1},
    "decode_block": lambda r: not r["failures"],
    "failure_replays": lambda r: r["failures"][:1] == [0] and r["replayed"]
    and r["alive"][1],
    "all_dead_raises": lambda r: r["failures"] == [0],
    "transient_keeps_replica": lambda r: r["transients"][:1] == [0]
    and not r["failures"] and r["alive"] == [True] and r["replayed"],
    "out_of_memory_is_transient": lambda r: r["transients"][:1] == [0]
    and not r["failures"] and r["alive"] == [True] and r["replayed"],
    "reprobe_revives": lambda r: r["failures"] and 0 in r["revived"],
}
# requests each scenario serves
N_REQS = {"matches_single_engine": 5, "balances_load": 4, "decode_block": 5,
          "failure_replays": 4, "all_dead_raises": 1,
          "transient_keeps_replica": 4, "out_of_memory_is_transient": 4,
          "reprobe_revives": 6}


def _tie_rule(got, want, prompts, params, cfg):
    """Equal streams, or a first divergence at a near-tie of the JAX
    model (the module docstring)."""
    assert sorted(got) == sorted(want)
    for uid in sorted(want):
        sj, st = want[uid], got[uid]
        assert len(st) == len(sj) == MAX_NEW, uid
        diff = [i for i, (a, b) in enumerate(zip(sj, st)) if a != b]
        if not diff:
            continue
        i = diff[0]
        toks = np.concatenate([prompts[uid], np.asarray(sj[:i], np.int32)])
        logits, _ = jllama.forward(params, jnp.asarray(toks)[None], cfg)
        lg = np.asarray(logits[0, -1], np.float32)
        top2 = np.sort(lg)[-2:]
        gap = float(top2[1] - top2[0])
        bound = 2 ** -5 * float(np.abs(lg).max())
        assert gap < bound, (f"request {uid} diverges at token {i} with a "
                             f"top-2 gap {gap} >= {bound}")


@pytest.mark.parametrize("kind", ["jax", "seeded"])
@pytest.mark.parametrize("name", list(EXPECT))
def test_cluster_matches_jax_cluster(models, name, kind):
    """The scenario through both routers: equal bookkeeping, the port's
    tokens its single Engine's bit for bit and the JAX Cluster's under the
    module's rule; each router meets tests/test_cluster.py's assertions."""
    jax_pkg, port_pkg = _pkgs(models)
    prompts = _prompts(kind)
    want = _scenario(jax_pkg, name, prompts, port=False)
    got = _scenario(port_pkg, name, prompts, port=True)
    for key in ("first", "failures", "transients", "replayed", "revived",
                "alive"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert EXPECT[name](want) and EXPECT[name](got)
    if name == "all_dead_raises":
        return
    n = N_REQS[name]
    single = port_pkg.engines(8)[0].run(port_pkg.reqs(prompts, n))
    assert got["got"] == single
    if kind == "jax":
        assert got["got"] == want["got"]
    else:
        _tie_rule(got["got"], want["got"], prompts, models["params"],
                  models["cfg"])


def test_out_of_memory_error_is_transient():
    """torch.cuda.OutOfMemoryError's repr, as the router and a replica's
    pipe carry it, classifies transient; the JAX markers stay transient
    and other errors fatal."""
    classify = tcluster.Cluster._classify
    assert classify(repr(_oom())) == "transient"
    assert classify(repr(RuntimeError(repr(_oom())))) == "transient"
    for why in ("paged KV pool exhausted", "no free slot",
                "XlaRuntimeError: ResourceExhausted: out of memory"):
        assert classify(repr(RuntimeError(why))) == "transient"
        assert jcluster.Cluster._classify(repr(RuntimeError(why))) \
            == "transient"
    assert classify(repr(RuntimeError("device lost"))) == "fatal"
    assert set(jcluster.TRANSIENT_MARKERS) < set(tcluster.TRANSIENT_MARKERS)
