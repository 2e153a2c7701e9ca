"""The plain reference against the program at a tiny size on the CPU, on
the harness's seeded weights, in float32: each family's logits at every
position agree; the fp8 control does not."""
import pytest
import torch

from perfbench import harness
from perfbench.conftest import TINY_SIZES
from perfbench.reference import decoder
from perfbench.reference.decoder import logits_at
from perfbench.weights import make_params


def program_logits(cfg, params, tokens):
    from repro_torch.models import Model
    with torch.no_grad():
        logits, _ = Model(cfg).forward(params, torch.as_tensor([tokens]))
    return logits[0, :, :cfg.vocab].float()


@pytest.mark.parametrize("name", sorted(TINY_SIZES))
def test_reference_matches_program(name):
    arch, sizes = TINY_SIZES[name]
    config = {"name": name, "arch": arch, "dtype": "float32", "sizes": sizes}
    cfg = harness.arch_config(config, decoder)
    sz = harness.sizes_of(config, cfg)
    params = make_params(sz, seed=2 ** 33 + 5, device="cpu",
                         dtype=torch.float32)
    tokens = torch.randint(0, sz["vocab"], (37,),
                           generator=torch.Generator().manual_seed(1)).tolist()
    want = program_logits(cfg, params, tokens)
    got = logits_at(params, sz, [tokens], [range(len(tokens))])[0]
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-5 * scale
    low = logits_at(params, sz, [tokens], [range(len(tokens))],
                    quantize="fp8")[0]
    assert (low - want).abs().max() > 1e-3 * scale


def test_reference_takes_sequences_of_any_length_together():
    arch, sizes = TINY_SIZES["tiny-moe"]
    config = {"name": "m", "arch": arch, "dtype": "float32", "sizes": sizes}
    sz = harness.sizes_of(config, harness.arch_config(config, decoder))
    params = make_params(sz, seed=3, device="cpu", dtype=torch.float32)
    a, b = list(range(5, 30)), list(range(40, 49))
    both = logits_at(params, sz, [a, b], [[3, 24], [0, 8]])
    alone = logits_at(params, sz, [b], [[0, 8]])
    assert torch.equal(both[1], alone[0])
    assert both[0].shape == (2, sz["vocab"])
