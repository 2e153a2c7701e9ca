"""The comparison that decides ``correct`` catches the faults a serving
cell can have, planted in the program underneath a tiny CPU run: a token
altered where it is produced, a step that leaves the state unchanged
(the prompt's KV never written), and half of the batch left out (its
rows given the other half's results).  A one-card cell has no exchange
between cards to leave out."""
import time

import pytest
import torch

from perfbench import cells, harness

SEED = 2 ** 31 + 777


def altered_token(monkeypatch):
    from repro_torch.serve import sampler
    greedy = sampler.greedy

    def wrong(logits, vocab):
        return (greedy(logits, vocab) + 1) % vocab
    monkeypatch.setattr(sampler, "greedy", wrong)


def state_unchanged(monkeypatch):
    from repro_torch.serve.engine import ServingEngine
    monkeypatch.setattr(ServingEngine, "_write_slot_from_prefill",
                        lambda self, slot, cache, n: None)


def half_batch(monkeypatch):
    from repro_torch.models import Model
    decode = Model.decode

    def half(self, params, cache, tokens):
        logits, cache = decode(self, params, cache, tokens)
        B = logits.shape[0]
        logits = torch.cat([logits[:B - B // 2], logits[:B // 2]])
        return logits, cache
    monkeypatch.setattr(Model, "decode", half)


@pytest.mark.parametrize("fault", [altered_token, state_unchanged,
                                   half_batch])
@pytest.mark.parametrize("workload", ["dense.open", "moe.open"])
def test_fault_comes_out_incorrect(tiny_root, monkeypatch, fault, workload):
    fault(monkeypatch)
    cell = cells.load(tiny_root, workload)
    out = harness.serve_cell(cell, SEED, 1.0, False, "cpu",
                             time.perf_counter())
    assert not out["correct"], out["checks"]
    assert any(c["value"] is not None and c["value"] > c["limit"]
               for c in out["checks"].values())
