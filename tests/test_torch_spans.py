"""The port's profiler spans and wait counts inside the serving iteration
(``repro_torch.obs.spans``), on the CPU at a tiny size.

Under a ``torch.profiler`` every span of the serving iteration appears,
nested as the code nests it; without one no range is made and every span
is the one shared no-op; a training step records none; and the wait
counts of an iteration equal a count by hand of the code's sites.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import SimRequest  # noqa: E402
from repro_torch.obs import span  # noqa: E402
from repro_torch.obs import spans as obs_spans  # noqa: E402
from repro_torch.runtime.backends.torch_engine import TorchBackend  # noqa: E402
from repro_torch.runtime.scheduler import ScheduledWork  # noqa: E402
from repro_torch.serve import ServingEngine  # noqa: E402
from repro_torch.serve.driver import engine_instance_cfg  # noqa: E402

#: every span of a dense model's serving iteration
SERVING = {"backend.decode_step", "backend.prefill_chunk", "backend.sync",
           "stage", "sample", "write_slot", "bookkeep", "model.decode",
           "model.prefill", "model.extend", "embed", "head", "attn.proj",
           "attn.rope", "attn.kv_write", "attn.kernel", "attn.out", "mlp",
           "wait.h2d", "wait.d2h", "wait.sync"}


def _backend(arch="llama3.1-8b-tiny"):
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    eng = ServingEngine(cfg, max_batch=2, max_len=256, name="e0",
                        device="cpu")
    return TorchBackend(eng, engine_instance_cfg(eng)), cfg


def _requests(vocab):
    g = torch.Generator().manual_seed(0)
    a = SimRequest(req_id=0, arrival=0.0, output_len=8,
                   prompt_tokens=torch.randint(0, vocab, (40,),
                                               generator=g).tolist())
    b = SimRequest(req_id=1, arrival=0.0, output_len=8,
                   prompt_tokens=torch.randint(0, vocab, (100,),
                                               generator=g).tolist())
    return a, b


def _iterations(backend, a, b):
    """Prefill A whole (40 tokens, one chunk); decode A alone; B's first
    chunk (64 tokens); A's decode beside B's last chunk (36 tokens, an
    extend that completes B's prompt).  Returns each iteration's waits."""
    waits = []
    for work in ([ScheduledWork(a, 40, "prefill")],
                 [ScheduledWork(a, 1, "decode")],
                 [ScheduledWork(b, 64, "prefill")],
                 [ScheduledWork(a, 1, "decode"),
                  ScheduledWork(b, 36, "prefill")]):
        backend.execute(work, 0.0)
        waits.append(backend.iteration_waits())
    return waits


def _ranges(prof):
    cpu = torch.autograd.DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu and e.name().startswith("repro_torch."):
            s = e.start_ns()
            out.append((s, s + e.duration_ns(),
                        e.name()[len("repro_torch."):]))
    return out


def _inside(inner, outers):
    s, e, _ = inner
    return any(a <= s and e <= b for a, b, _ in outers)


def test_wait_counts_equal_a_count_by_hand():
    """page_size 64, max_batch 2, a dense model (no sentinel, no state):

    1. prefill of A, 40 tokens from 0, completing: h2d n_new, pad, and the
       block table's push as the slot takes its first page; d2h the first
       token; one sync.
    2. decode of A alone (41 tokens fit its page): h2d the tokens; d2h the
       sampled tokens; every slot holding KV is scheduled, so no lengths
       re-push; one sync.
    3. B's first chunk: as 1, without the read-back.
    4. decode of A beside B's extend of 36 tokens from 64, completing:
       h2d the decode's tokens and the lengths re-push (B is not
       decoding), then n_new, the table push (B's second page), the
       subcache's length and the pad; d2h the decode's tokens and B's first
       token; one sync."""
    backend, cfg = _backend()
    waits = _iterations(backend, *_requests(cfg.vocab))
    assert waits == [{"h2d": 3, "d2h": 1, "sync": 1},
                     {"h2d": 1, "d2h": 1, "sync": 1},
                     {"h2d": 3, "d2h": 0, "sync": 1},
                     {"h2d": 6, "d2h": 2, "sync": 1}]


@pytest.mark.parametrize("arch, layer", [("llama3.1-8b-tiny", "mlp"),
                                         ("phimini-moe-tiny", "moe")])
def test_spans_appear_nested_under_a_profiler(arch, layer):
    backend, cfg = _backend(arch)
    a, b = _requests(cfg.vocab)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _iterations(backend, a, b)
    ranges = _ranges(prof)
    names = {n for _, _, n in ranges}
    want = SERVING - {"mlp"} | {layer}
    assert want <= names, want - names
    assert ({"mlp", "moe"} - {layer}).isdisjoint(names)

    def named(*prefixes):
        return [r for r in ranges if r[2].startswith(prefixes)]
    models = named("model.")
    for r in named("model.decode"):
        assert _inside(r, named("backend.decode_step"))
    for r in named("model.prefill", "model.extend"):
        assert _inside(r, named("backend.prefill_chunk"))
    for r in named("attn.", "embed", "head", layer):
        assert _inside(r, models), r
    for r in named("stage", "sample", "write_slot", "bookkeep"):
        assert _inside(r, named("backend.")), r
    for r in named("wait.sync"):
        assert _inside(r, named("backend.sync"))
    # one span of each layer part per layer and call
    layers = sum(st.n_layers for st in cfg.stages)
    for part in ("attn.proj", "attn.kernel", "attn.out", layer):
        assert sum(n == part for _, _, n in ranges) == len(models) * layers
    assert sum(n == "model.decode" for _, _, n in ranges) == 2


def test_no_profiler_no_range(monkeypatch):
    """Without a profiler every span is the one shared no-op, and a serve
    makes no profiler range."""
    assert not torch.autograd._profiler_enabled()
    assert span("model.decode") is obs_spans.NOOP
    assert span("attn.kernel") is span("wait.h2d") is obs_spans.NOOP
    made = []
    real = obs_spans._range

    def counting(*args, **kw):
        made.append(args)
        return real(*args, **kw)
    monkeypatch.setattr(obs_spans, "_range", counting)
    backend, cfg = _backend()
    _iterations(backend, *_requests(cfg.vocab))
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("probe"):
            pass
    assert made == [("repro_torch.probe",)]


def test_training_records_no_span():
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("llama3.1-8b-tiny"),
                              compute_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, 16))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.forward(params, tokens)
    assert _ranges(prof) == []
