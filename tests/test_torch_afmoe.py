"""The port's afmoe pieces (trinity-mini), on the CPU at a tiny size: the
sigmoid router; the parameter count against the drawn parameters; the
windows counted over the whole model, MoE layers included, and RoPE only
on the local layers; the MoE layers' row counts on each ``iter`` event and
their spans; tensor parallelism refused by name.  The program against the
plain reference is ``perfbench/test_perfbench_afmoe.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ATTN_MLP, ATTN_MOE, Stage  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.sharding import unsupported  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.moe import sigmoid_topk  # noqa: E402
from repro_torch.obs import EventRecorder  # noqa: E402
from repro_torch.serve import ServeDriver, ServingEngine  # noqa: E402
from repro_torch.serve.driver import DriverCfg  # noqa: E402
from repro_torch.workload import ShareGPTConfig, generate  # noqa: E402

MOE_SPANS = {"moe.route", "moe.dispatch", "moe.experts", "moe.shared",
             "moe.combine"}


def _tiny(**kw):
    return dataclasses.replace(get_config("trinity-mini-tiny"),
                               compute_dtype="float32", **kw)


# --------------------------------------------------------------------------
# the sigmoid router
# --------------------------------------------------------------------------

def test_sigmoid_router_picks_by_the_bias_and_weighs_without_it():
    """Identity router weights make the logits the input: the bias moves
    expert 3 past expert 0 for the pick, the weights are the unbiased
    sigmoid scores of the picked, over their sum, times the scale."""
    x = torch.tensor([[2.0, 1.0, 0.5, 1.9]])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.2])
    idx, w, aux = sigmoid_topk(x, torch.eye(4), 2, bias, route_scale=2.5)
    assert idx.dtype == torch.int32 and idx.tolist() == [[3, 0]]
    s = torch.sigmoid(x[0, [3, 0]])
    torch.testing.assert_close(w[0], s / s.sum() * 2.5, rtol=0, atol=0)
    assert float(aux) == 0.0
    idx, w, _ = sigmoid_topk(x, torch.eye(4), 2, None, route_scale=1.0)
    assert idx.tolist() == [[0, 3]]
    torch.testing.assert_close(w.sum(), torch.tensor(1.0))


def test_sigmoid_router_ties_go_to_the_lower_index():
    x = torch.tensor([[0.5, 1.0, 1.0, 0.5, 1.0]])
    idx, _, _ = sigmoid_topk(x, torch.eye(5), 2)
    assert idx.tolist() == [[1, 2]]
    idx, _, _ = sigmoid_topk(x, torch.eye(5), 4, torch.zeros(5))
    assert idx.tolist() == [[1, 2, 4, 0]]


def test_sigmoid_router_product_is_float32():
    """bf16 inputs and weights: the product is taken in float32, not
    rounded to bf16 before the sigmoid."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((64, 256), generator=g).bfloat16()
    w = torch.randn((256, 16), generator=g).bfloat16() / 16
    _, got, _ = sigmoid_topk(x, w, 4)
    s = torch.sigmoid(x.float() @ w.float())
    idx = torch.sort(s, dim=-1, descending=True, stable=True).indices[:, :4]
    want = s.gather(1, idx)
    torch.testing.assert_close(got, want / (want.sum(-1, keepdim=True)
                                            + 1e-20), rtol=0, atol=0)


# --------------------------------------------------------------------------
# what the model holds and runs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["trinity-mini", "phimini-moe"])
def test_param_count_equals_the_drawn_parameters(arch):
    """``param_count`` counts the published vocabulary and no QK-norm
    scales (as the JAX package's count does); every other drawn parameter
    is counted, the shared expert, the output gate, the sandwich norms and
    the expert bias among them."""
    cfg = get_config(arch)
    params = Model(cfg).init(torch.Generator(), device="meta")
    numel = 0
    stack = [params]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        else:
            numel += t.numel()
    pad = 2 * (cfg.padded_vocab - cfg.vocab) * cfg.d_model
    qk = 2 * cfg.d_head * cfg.n_layers if cfg.qk_norm else 0
    assert cfg.param_count() == numel - pad - qk
    if arch == "trinity-mini":
        assert cfg.param_count() == 26_123_966_208


def _windows_and_ropes(cfg, monkeypatch):
    """The window of each flash call and the number of RoPE calls of one
    prefill."""
    windows, ropes = [], []
    flash, rope = ops.flash_attention, ops.rope

    def flash_w(q, k, v, lengths=None, window=None, return_lse=False):
        windows.append(window)
        return flash(q, k, v, lengths, window, return_lse)

    def rope_w(*a, **kw):
        ropes.append(1)
        return rope(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", flash_w)
    monkeypatch.setattr(ops, "rope", rope_w)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.prefill(params, torch.randint(0, cfg.vocab, (1, 24)))
    return windows, len(ropes)


def test_windows_count_layers_over_the_whole_model(monkeypatch):
    """Two dense layers then six MoE layers, period 4: layers 3 and 7 are
    global (an MoE stage's own count would make 5 global), every other
    layer, the MoE ones included, has the window, and RoPE runs on the
    local layers alone."""
    cfg = _tiny(n_layers=8, stages=(Stage(ATTN_MLP, 2, 4),
                                    Stage(ATTN_MOE, 6, 4)))
    windows, ropes = _windows_and_ropes(cfg, monkeypatch)
    W, G = cfg.sliding_window, 2 ** 30
    assert windows == [W, W, W, G, W, W, W, G]
    assert ropes == 6
    # with RoPE everywhere, every layer rotates
    _, ropes = _windows_and_ropes(
        dataclasses.replace(cfg, rope_local_only=False), monkeypatch)
    assert ropes == 8


def test_tensor_parallel_refuses_the_new_weights_by_name():
    why = unsupported(get_config("trinity-mini"), 2)
    for name in ("attn.wg", "moe.shared_", "moe.expert_bias"):
        assert name in why
    assert unsupported(get_config("phimini-moe"), 2) is None


# --------------------------------------------------------------------------
# the MoE layers' counts and spans in a serve
# --------------------------------------------------------------------------

def _serve(cfg, recorder=None, n=4):
    eng = ServingEngine(cfg, max_batch=2, max_len=128, name="e0",
                        device="cpu")
    driver = ServeDriver([eng], DriverCfg(), recorder=recorder)
    reqs = generate(ShareGPTConfig(n_requests=n, rate=50.0, seed=3,
                                   vocab=cfg.vocab, max_prompt=40,
                                   max_output=6))
    driver.run(reqs)
    return eng


@pytest.mark.parametrize("arch", ["trinity-mini-tiny", "phimini-moe-tiny"])
def test_moe_layers_add_no_wait_and_no_iter_payload(arch):
    """A serve of a model with MoE layers records ``iter`` events of a
    dense model's form: the same payload keys, and one synchronize an
    iteration in ``Event.host`` (the router and the dispatch read nothing
    back to the host)."""
    def iters(name):
        cfg = dataclasses.replace(get_config(name), compute_dtype="float32")
        rec = EventRecorder()
        _serve(cfg, rec)
        return [e for e in rec.events if e.kind == "iter"]
    dense = iters("llama3.1-8b-tiny")
    keys = {k for e in dense for k in e.payload}
    got = iters(arch)
    assert got
    for e in got:
        assert set(e.payload) <= keys, set(e.payload) - keys
        assert set(e.host) == {"h2d", "d2h", "sync"}
        assert e.host["sync"] == 1


def test_moe_spans_nest_inside_the_moe_span():
    cfg = _tiny()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(cfg, n=2)
    cpu = torch.autograd.DeviceType.CPU
    ranges = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu and e.name().startswith("repro_torch."):
            s = e.start_ns()
            ranges.append((s, s + e.duration_ns(),
                           e.name()[len("repro_torch."):]))
    names = {n for _, _, n in ranges}
    assert MOE_SPANS | {"attn.gate", "moe", "mlp"} <= names
    outer = [r for r in ranges if r[2] == "moe"]
    for s, e, n in ranges:
        if n in MOE_SPANS:
            assert any(a <= s and e <= b for a, b, _ in outer), n
    # one of each a MoE layer call; the gate one an attention layer call
    calls = sum(n == "moe" for _, _, n in ranges)
    for n in MOE_SPANS:
        assert sum(m == n for _, _, m in ranges) == calls, n
    assert sum(n == "attn.gate" for _, _, n in ranges) == \
        sum(n == "attn.out" for _, _, n in ranges)


def test_a_dense_model_makes_no_moe_span():
    cfg = dataclasses.replace(get_config("llama3.1-8b-tiny"),
                              compute_dtype="float32")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(cfg, n=2)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not {"repro_torch." + n for n in MOE_SPANS | {"moe",
                                                          "attn.gate"}} \
        & names
