"""The real radix prefix store on the port against the JAX package.

``ServingEngine(prefix_cache=True)`` carries a ``RealRadixCache`` (KV
payloads keyed by token prefix on the device, host and SSD tiers);
``TorchBackend`` matches it on a runtime prefix hit, restores the payload
into the request's slot and extends from the restored length, inserts each
finished prompt, and carries out the runtime's tier moves.  Held to: the
port's simulator (the twin of ``tests/test_kv_tiers.py``'s
``test_sim_real_tier_hit_and_restore_accounting_parity``),
the JAX ``kernels="reference"`` engine on the same weights (tokens,
decisions and KV-tier counters), and the JAX store (bytes moved over a
device -> host -> SSD -> device round trip).  Card only (``-m cuda``): a
tiny f32 prefix-cached serve on the card equals the CPU's.

The JAX side is imported inside the tests that need it, so the card test
runs on a machine without JAX.
"""
import copy
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ClusterCfg, RouterCfg  # noqa: E402
from repro_torch.core.cluster import Cluster  # noqa: E402
from repro_torch.core.config import (SchedulerCfg,  # noqa: E402
                                     engine_scheduler_cfg)
from repro_torch.serve import (DriverCfg, RealRadixCache,  # noqa: E402
                               ServeDriver, ServingEngine)
from repro_torch.serve.driver import engine_instance_cfg  # noqa: E402
from repro_torch.workload.sharegpt import Request  # noqa: E402

ARCH = "llama3.1-8b-tiny"
#: the KV-tier counters both engines report (tier_move_s is wall time)
COUNTERS = ("residency_blocks", "hit_tokens", "transfers",
            "restored_tokens", "restore_events", "tier_moves",
            "store_residency")


def _grouped_workload(vocab, n_groups=2, tail=8, cls=Request):
    """Two phases: A (t = 0) fills the cache, B (t = 1e6, long after A on
    either time axis) hits it; the shared prefixes are 32 tokens, whole
    blocks, so the radix tree and the store agree on restored lengths."""
    reqs, rid = [], 0
    for g in range(n_groups):
        base = [(g * 977 + j * 13) % vocab for j in range(32)]
        reqs.append(cls(req_id=rid, arrival=0.0,
                        prompt_tokens=base + [(g * 31 + 1 + j) % vocab
                                              for j in range(tail)],
                        output_len=4))
        rid += 1
    for g in range(n_groups):
        base = [(g * 977 + j * 13) % vocab for j in range(32)]
        for k in range(2):
            reqs.append(cls(req_id=rid, arrival=1e6,
                            prompt_tokens=base
                            + [(g * 53 + k * 7 + 2 + j) % vocab
                               for j in range(tail)],
                            output_len=4))
            rid += 1
    return reqs


def _port_run(cfg, reqs, sched, device="cpu", params=None):
    eng = ServingEngine(cfg, params, max_batch=2, max_len=256,
                        prefix_cache=True, name="e0", device=device)
    drv = ServeDriver([eng], DriverCfg(scheduler=sched))
    for inst in drv.runtime.instances.values():
        inst.cache.capacity_blocks = 3        # forces a device->host spill
    m = drv.run([copy.deepcopy(r) for r in reqs], warmup=False)
    inst = drv.runtime.instances["e0"]
    return m, dict(inst.backend.out_tokens), list(inst.decisions), drv, eng


def test_sim_real_tier_hit_and_restore_accounting_parity():
    """The port's engine and the port's simulator on one shared-prefix
    workload: the same decisions and the same tier-hit, transfer and
    restore accounting; the hits restore through the host tier."""
    cfg = get_config(ARCH)
    reqs = _grouped_workload(cfg.vocab)
    sched = engine_scheduler_cfg(2)
    real, _, real_dec, drv, eng = _port_run(cfg, reqs, sched)
    sim_cluster = Cluster(ClusterCfg(
        instances=(engine_instance_cfg(eng, sched),),
        router=RouterCfg("round_robin")))
    for inst in sim_cluster.instances.values():
        inst.cache.capacity_blocks = 3
    sim_cluster.submit_workload([copy.deepcopy(r) for r in reqs])
    sim = sim_cluster.run()
    assert real["finished"] == sim["finished"] == len(reqs)
    assert real_dec == list(sim_cluster.instances["e0"].decisions)
    rkv = real["instances"]["e0"]["kv_tiers"]
    skv = sim["instances"]["e0"]["kv_tiers"]
    for key in ("residency_blocks", "hit_tokens", "transfers"):
        assert rkv[key] == skv[key], key
    assert rkv["restored_tokens"] == skv["restored_tokens"] > 0
    assert rkv["restore_events"] == skv["restore_events"] > 0
    assert rkv["transfers"].get("device->host", {}).get("blocks", 0) >= 1
    assert rkv["hit_tokens"]["host"] + rkv["hit_tokens"]["ssd"] > 0
    assert real["instances"]["e0"]["prefix_cache"] == \
        sim["instances"]["e0"]["prefix_cache"]
    assert rkv["tier_moves"] >= 1 and rkv["tier_move_s"] > 0
    assert real["e0_cache_hits"] > 0
    for inst in (*sim_cluster.instances.values(),
                 *drv.runtime.instances.values()):
        inst.cache.check_invariants()


@pytest.mark.parametrize("chunked", [False, True])
def test_prefix_engine_matches_jax_engine(chunked):
    """The JAX ``kernels="reference"`` engine and the port's, both with
    ``prefix_cache=True``, on the same weights and workload: the same
    tokens, decisions and KV-tier counters, and a restore happened."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.core.config import SchedulerCfg as JaxSchedulerCfg
    from repro.core.config import \
        engine_scheduler_cfg as jax_engine_scheduler_cfg
    from repro.serve import DriverCfg as JaxDriverCfg
    from repro.serve import ServeDriver as JaxServeDriver
    from repro.serve import ServingEngine as JaxServingEngine
    from repro.workload.sharegpt import Request as JaxRequest
    from repro_torch.convert import params_from_numpy

    jcfg = dataclasses.replace(jax_get_config(ARCH), compute_dtype="float32",
                               kernels="reference")
    tcfg = dataclasses.replace(get_config(ARCH), compute_dtype="float32")
    if chunked:
        kw = dict(max_batch_size=2, max_batch_tokens=64,
                  chunked_prefill=True, prefill_chunk=16)
        jsched, tsched = JaxSchedulerCfg(**kw), SchedulerCfg(**kw)
    else:
        jsched, tsched = jax_engine_scheduler_cfg(2), engine_scheduler_cfg(2)
    jeng = JaxServingEngine(jcfg, max_batch=2, max_len=256,
                            prefix_cache=True, name="e0")
    assert not jeng.paged
    jdrv = JaxServeDriver([jeng], JaxDriverCfg(scheduler=jsched))
    for inst in jdrv.runtime.instances.values():
        inst.cache.capacity_blocks = 3
    jres = jdrv.run(_grouped_workload(jcfg.vocab, cls=JaxRequest),
                    warmup=False)
    jinst = jdrv.runtime.instances["e0"]
    tres, ttok, tdec, _, teng = _port_run(
        tcfg, _grouped_workload(tcfg.vocab), tsched,
        params=params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        jeng.params)))
    assert jres["finished"] == tres["finished"] == 6
    assert ttok == jinst.backend.out_tokens
    assert tdec == list(jinst.decisions)
    jkv = jres["instances"]["e0"]["kv_tiers"]
    tkv = tres["instances"]["e0"]["kv_tiers"]
    for key in COUNTERS:
        assert tkv[key] == jkv[key], key
    assert tkv["restore_events"] > 0
    assert tres["instances"]["e0"]["kv_store_hits"] == \
        jres["instances"]["e0"]["kv_store_hits"] > 0
    assert teng.radix.residency() == jeng.radix.residency()


def _payload(rng, n_layers=2, blen=32, kv=2, dh=16):
    data = {f"stage{i}": {name: rng.standard_normal(
        (n_layers, blen, kv, dh)).astype(np.float32) for name in ("k", "v")}
        for i in range(2)}
    return data, {"_length": blen - 3, "_length_bucket": blen}


def test_store_round_trip_bytes_match_jax():
    """One payload in the port's store and in the JAX store: device ->
    host -> SSD -> device moves the same bytes at every step, the SSD
    tier is a spill file that the promotion removes, the payload comes
    back unchanged, and eviction and drop remove their spill files."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.serve.engine import RealRadixCache as JaxRadixCache
    rng = np.random.default_rng(4)
    data, meta = _payload(rng)
    toks = list(range(40))
    port = RealRadixCache(block=16)
    ref = JaxRadixCache(block=16)
    port.insert(toks, {**{k: {n: torch.from_numpy(a) for n, a in v.items()}
                          for k, v in data.items()}, **meta})
    ref.insert(toks, {**{k: {n: jnp.asarray(a) for n, a in v.items()}
                         for k, v in data.items()}, **meta})
    prefix = toks[:16]
    moved = []
    for step in ("host", "ssd", "device", "ssd"):
        if step == "device":
            got, want = port.promote(prefix), ref.promote(prefix)
        else:
            got, want = port.demote(prefix, step), ref.demote(prefix, step)
        moved.append(got)
        assert got == want > 0, step
        assert port.residency() == ref.residency()
        entry = port.store[tuple(toks[:32])]
        if step == "ssd":
            assert set(entry) == {"_ssd", "_length", "_length_bucket"}
            assert os.path.isfile(entry["_ssd"])
            spill = entry["_ssd"]
        elif step == "device":
            assert not os.path.exists(spill)     # promotion removed it
    assert moved[0] == sum(a.nbytes for v in data.values()
                           for a in v.values())
    # a matched SSD stub resolves to the payload it stored
    length, stub = port.match(toks)
    assert length == 32
    back = port.resolve(stub)
    assert back["_length"] == meta["_length"]
    for key, v in data.items():
        for name, a in v.items():
            assert np.array_equal(back[key][name].numpy(), a)
    port.drop(prefix)
    assert not os.path.exists(stub["_ssd"]) and not port.store
    # eviction past max_entries unlinks the oldest entry's spill file
    small = RealRadixCache(block=16, max_entries=1)
    small.insert(toks, {**{k: {n: torch.from_numpy(a) for n, a in v.items()}
                           for k, v in data.items()}, **meta})
    small.demote(prefix, "ssd")
    path = small.store[tuple(toks[:32])]["_ssd"]
    small.insert([t + 1 for t in toks], dict(meta))
    assert not os.path.exists(path) and len(small.store) == 1


def test_ssd_spill_that_fails_raises(monkeypatch, tmp_path):
    """A spill the disk refuses raises; the entry is never left half on
    the SSD tier."""
    rng = np.random.default_rng(5)
    data, meta = _payload(rng)
    store = RealRadixCache(block=16)
    store.insert(list(range(32)),
                 {**{k: {n: torch.from_numpy(a) for n, a in v.items()}
                     for k, v in data.items()}, **meta})
    store._ssd_dir = str(tmp_path / "missing" / "dir")
    with pytest.raises(OSError):
        store.demote(list(range(16)), "ssd")
    assert store.residency() == {"device": 1, "host": 0, "ssd": 0}


# --------------------------------------------------------------------------
# card: a restored prefix extends through the paged kernels
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_prefix_serve_on_card_equals_cpu():
    """Tiny f32 llama with the prefix store, on the card (kernels: the
    restored prefix's extend runs the paged extend kernel from the
    restored start) and on the CPU (plain versions), same weights: the
    same tokens, decisions and KV-tier counters."""
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a card with compute capability 9.0")
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(ARCH), compute_dtype="float32")
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    sched = SchedulerCfg(max_batch_size=2, max_batch_tokens=64,
                         chunked_prefill=True, prefill_chunk=16)
    runs = {dev: _port_run(cfg, _grouped_workload(cfg.vocab), sched,
                           device=dev, params=params)
            for dev in ("cpu", "cuda")}
    assert runs["cuda"][1:3] == runs["cpu"][1:3]
    kv = {dev: r[0]["instances"]["e0"]["kv_tiers"] for dev, r in
          runs.items()}
    for key in COUNTERS:
        assert kv["cuda"][key] == kv["cpu"][key], key
    assert kv["cuda"]["restore_events"] > 0
