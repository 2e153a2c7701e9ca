"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. the card: name and power limit, torch and CUDA versions, compute
   capability (9.0 required); TF32 off; the kernels built from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (the flash
   backward too; the grouped matmul's library holds its backward), and the
   count of tensor-core (``HGMMA``) instructions in each library, which
   must not be 0 for any of them (their bf16 prefill, backward, extend and
   matmul kernels);
2. each kernel against its plain PyTorch version on the card, in f32 and
   bf16, on the awkward shapes of ``tests/test_kernel_backends.py`` and
   ``tests/test_kernels.py`` and on the main paths' own shapes (flash at
   every prefill chunk of 16 to 256, paged decode and extend at the serve's
   shapes and at groups of 1 to 9 query heads per kv-head with decode
   splits and windows, paged extend at speculative verify's shape, B8 S5
   from ragged starts 1..2043 and from page edges, the grouped matmul's
   gate/up and down at every capacity C of 1 to 40, phase 6's
   per-rank shapes at tp = 2: H16 KV4 (verify's B8 S5 too) and 8
   experts, and phase 7's
   zamba2-1.2b shapes, one query head per kv-head at head dim 64: flash
   at S 16 and 256, paged decode at B8 H32 KV32 over the ragged lengths,
   paged extend of 256 from start 293 across page edges); the flash
   forward's log-sum-exp and the flash backward's dq, dk, dv at
   demo-110m's heads (S 128 and 1024), llama3.1-8b's (S 1024),
   musicgen-large's (G = 1), a window, ragged lengths, S 100, head dims
   16 and 32, and the edges of the 64-row tiles (S 65 and 129, a window
   of 64, G = 3 at head dim 16); the grouped matmul's backward (dx, dw)
   at a serve chunk (E16 C40 d4096 f960), phimini-moe's training shapes
   (E16 C320, gate/up and down), granite-moe-3b's (E40 C512 d1536 f512)
   and awkward ones (C past a 64-row stage, widths off 8), group sizes 0,
   1, 63, 64, 65 and C mixed across experts; for the persistent grid one
   expert of 1024 rows (fewer tiles than SMs), four empty groups (dw
   exactly 0) and groups of 127, 128, 129 at C 320; NaN in x's and dy's
   rows past each group (they must take no part), dx's rows there exactly
   0; every kernel must also give bitwise the same result on a second
   launch;
3. each kernel timed at the main paths' shapes with CUDA events, beside
   its plain version, a PyTorch library call computing the same function,
   and the least time the card could take (the grouped matmul at gate/up
   and down, each at a 256-token chunk and at decode; paged extend also at
   the verify shape, and at a rank's verify, B8 S5 H16 KV4, for phase 6's
   tp = 2 spec serve; the three attention kernels also at zamba2-1.2b's
   H32 KV32 dh64; the flash backward at demo-110m's training step, B8
   S1024 H12 KV4 dh64, and at llama3.1-8b's, B2 S1024 H32 KV8 dh128,
   beside autograd through SDPA; the grouped matmul and its backward at
   phimini-moe's training step, E16 C320 from a seeded top-2 routing of
   2048 tokens, gate/up and down, the backward beside autograd through
   ``torch.bmm`` times the row mask and with its device time split
   between its dx and dw kernels by a profiled call), with the decode
   kernel's pages per split and split count, and the host's time to issue
   one call of each kernel's wrapper (the serves are host-bound);
4. serving: tiny f32 llama and phimini-moe models on the card must emit
   the same tokens and make the same decisions as on the CPU (the MoE one
   also under a replayed expert-routing trace, with equal expert-load
   counts); tiny f32 llama with the prefix store (tokens, decisions and
   KV-tier counters, restores through the host tier) and with speculative
   decoding under a perfect and an unrelated draft (both emitting exactly
   the vanilla greedy tokens) on the card equals the CPU, and the prefix
   store's device -> host -> SSD -> device round trip on the card; then
   three paths at full width, bf16, seeded random weights made on the
   card, each serving 8 requests through ``ServeDriver`` with chunked
   prefill, its launch counts set to 0 just before and read just after:
   llama3.1-8b (flash prefill, paged extend and decode), phimini-moe (the
   same three and the grouped expert matmul, 3 launches per MoE layer per
   model call), and llama3.1-8b speculating k = 4 with a draft sharing its
   weights under a replayed acceptance trace (alpha 0.6; every arrival at
   0; draft prefill on flash, draft decodes on paged decode, each verify
   one paged extend launch a layer at B8 S<=5), whose per-step accepted
   lengths must equal the port simulator's;
5. the paper's loop on the card: llama3.1-8b and then phimini-moe profiled
   at full width (batch 8, max_len 2048, bf16, the serve's seeded weights)
   through the profiler CLI's function (``profile --device h100 --mode
   measured --kernels``) on a grid that covers the serve, each artifact
   written under ``build/`` and reloaded through the port's hardware
   registry, with the launches of the kernel sweep and of the runtime
   probes read from the counters; then the Fig. 2 twin
   (``repro_torch.bench.fig2_fidelity``) on the serve's 8 requests: S(D),
   M(D), PD(D) and S(D)+PC (the prefix store, on a prefix-sharing variant
   of the requests) on llama3.1-8b and S(M) on phimini-moe, each with an
   event recorder on both sides, real against simulated TTFT p50, TPOT
   and tokens/s with their errors and the attribution's segment totals
   (queueing, prefill, decode, tier restore, handoff), each configuration
   with its launch counts; a structural gate only (every request finishes
   on both sides, its attribution sums to its e2e latency, the P/D
   handoff moves bytes on both sides, S(D)+PC restores a prefix on both
   sides, sim/real tokens/s within [0.5, 2]): 8 requests are too few to
   measure the error, which ``tools/torch_fidelity.py`` measures on more;
   and tiny f32 llama on the
   card and the port's simulator make the same decisions, unified and P/D;
6. tenants and tensor parallelism: two tenants (``generate_tenants``)
   served by tiny f32 llama on the card under ``policy="priority"`` make
   the port simulator's decisions and per-tenant rollup; then two ranks of
   one engine group share the card over gloo (``run_ranks`` with
   ``devices=["cuda:0", "cuda:0"]``; a correctness check of the sharded
   path, no time of it a TP speed): tiny f32 llama and phimini-moe (expert
   parallel, E4 -> E2 a rank) at tp = 2 emit tp = 1's tokens on the card
   and the CPU, decide alike on both ranks and as the port simulator at
   tp = 2, and give tp = 1's prefill and decode logits within 1e-5; tiny
   f32 llama at tp = 2 under P/D (rank r of the prefill engine handing off
   to rank r of the decode engine), with the prefix store walking device
   -> host -> SSD -> device (a spill directory a rank), and speculating
   (k = 3, an unrelated draft replaying an acceptance trace) equals tp =
   1 on the card in tokens, decisions, handoff bytes, KV-tier counters and
   ``spec_decode``, and decides as the simulator at tp = 2; so does tiny
   f32 llama under P/D between engines of different tp, 2 -> 1 (the
   prefill group all-gathers every KV head) and 1 -> 2 (each decode rank
   takes its own heads), the tp = 1 engine replicated on both ranks, in
   tokens, decisions and handoff bytes, deciding as the simulator at the
   engines' tp; then full-width bf16 llama3.1-8b and phimini-moe (E16 ->
   E8) at tp = 2 serve phase 4's 8 requests, and llama3.1-8b serves them
   under P/D (two shards a rank; the handoffs carry tp = 1's payload
   bytes), speculating at k = 4 (a tp = 1 draft holding the full weights
   on each rank, acceptance replayed at alpha 0.6, every arrival at 0;
   the accepted lengths equal the simulator's at tp = 2), and under P/D
   2 -> 1 and 1 -> 2 (a replica and a shard a rank, cut from one draw;
   tp = 1's handoff bytes; both ranks emit the same tokens), every
   request finishing, both ranks deciding alike, the kernels launched at
   the rank's shapes (16 query and 4 KV heads, 8 experts: phases 2 and 3
   hold and time them there; the draft and a replica at all 32 and 8),
   with the prefill argmax agreement with tp = 1 and each rank's memory
   and times printed;
7. the recurrent and hybrid families: zamba2-1.2b at full width (38
   layers, d_model 2048, bf16, seeded random weights, batch 8, max_len
   2048, chunked prefill of 256) serves 8 requests with prompts of
   128-1024 tokens and 64 output tokens each, every request finishing,
   flash, paged decode and paged extend launched at H32 KV32 dh64 (its
   shared attention), with TPOT p50, tokens/s and peak memory printed;
   the same model at published widths in f32 cut to one superblock,
   served twice on the card from the same weights, through the kernels
   and through their plain versions, must make the same decisions and
   emit the same tokens (the largest prefill-logit difference printed);
   xlstm-125m at full width (12 layers, d_model 768, bf16, whole-prompt
   prefill: it has no extend) serves 8 requests of at most 512 prompt
   tokens, every request finishing, and launches no kernel of the repo;
8. training: tiny f32 llama and musicgen (on embeddings) take 3 AdamW
   steps with remat and 2 microbatches on the card and on the CPU, equal
   within the stated tolerance, and tiny musicgen's prefill, extend and
   decode logits on embeddings too; so do tiny f32 phimini-moe and
   granite-moe-3b-a800m (top-8), through the grouped matmul and its
   backward kernel on the card; demo-110m at full width (12 layers,
   d_model 768, vocab 16384, bf16 compute, f32 params) trains 40 steps at
   B8 S1024 through ``repro_torch.launch.train``'s function, checkpointing
   at step 20, its loss falling, flash and its backward launched once a
   layer a step; a run resumed from step 20's checkpoint ends where the
   uninterrupted run does; llama3.1-8b cut to 2 layers (B2 S1024) and
   musicgen-large cut to 4 (B4 S1024, bf16 embeddings) and phimini-moe
   cut to 2 (B2 S1024) take 3 steps at published widths with remat (the
   forward kernels launched twice a layer a step, the backward ones once;
   phimini-moe's grouped matmul three times a layer in each), every
   gradient leaf nonzero, step 0's loss within 1 of ln vocab, with step
   times and peak memory;
9. the dry run against the card: llama3.1-8b and phimini-moe cut to 2
   layers, each a train step at B2 S1024 with remat (phase 8's shapes),
   and llama3.1-8b at full width in bf16, a B1 S2048 prefill, a 256-token
   extend after 1792 and a B8 decode at 2047 of 2048, each first counted
   on meta by the dry run's machinery (``repro_torch.launch.dryrun``: the
   operation counter, the kernels' meta branches and their work counts)
   and then run on the card: params and optimizer state equal in bytes,
   every kernel launched exactly as often as predicted, the FLOPs outside
   the kernels (counted over the card run) equal, and the card's peak
   allocation within [0.9, 1.1] of the predicted peak; the median step
   time printed beside the roofline's bound against the h100 preset;
10. a ``{"kernels": [...]}`` line, one row per timed shape, and, last, the
   ``{"ok": true, ...}`` line.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS_S = 989e12          # dense bf16 tensor-core peak
# f32: the kernels and the plain versions sum in other orders; bf16: inputs
# and outputs round to 8 mantissa bits.  Both compared in f32 as
# |got - want| <= tol + tol * |want|, the form of the JAX kernel tests.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: tensor-parallel degree of phase 6 (two ranks share the one card), and
#: the by-path keys of its full-width serves
TP = 2
TP2_PATH = "tp2 llama3.1-8b"
TP2_MOE_PATH = "tp2 phimini-moe"
TP2_PD_PATH = "tp2 PD(D) llama3.1-8b"
TP2_SPEC_PATH = "tp2 spec llama3.1-8b"
TP2_PD21_PATH = "tp 2->1 PD(D) llama3.1-8b"
TP2_PD12_PATH = "tp 1->2 PD(D) llama3.1-8b"
#: phase 6's P/D techniques -> the (prefill, decode) engines' tp; the tp =
#: 1 engine of a pair of different tp is replicated on both ranks
PD_TP = {"pd": (TP, TP), "pd-2to1": (TP, 1), "pd-1to2": (1, TP)}


def ranks_kw(group, tp):
    """An engine's tp arguments on a rank: one of ``group`` at tp > 1,
    replicated with ``group`` as its handle at tp = 1 (nothing off the
    ranks, ``group`` None)."""
    if group is None:
        return {}
    return dict(tp=tp, group=group) if tp > 1 else dict(replicas=group)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- phase 1
def card_and_setup(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: " + smi.stderr.strip()
    print(card)
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, compute capability "
          f"{cap[0]}.{cap[1]}")
    check(cap == (9, 0), f"compute capability {cap}, the kernels need 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN (f32 comparisons run in full f32)")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"built {sorted(paths)} with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s ({build.build_dir()})")
    for name in sorted(paths):
        log = build.build_dir() / f"{name}.log"
        if log.is_file():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")
    hgmma = hgmma_counts(paths)
    print(f"HGMMA instructions (cuobjdump -sass): {json.dumps(hgmma)}")
    for name in ("flash_attention", "flash_attention_bwd", "paged_attention",
                 "moe_gmm"):
        check(hgmma[name] > 0, f"{name}: no HGMMA instruction in its "
                               f"library, the bf16 kernel is not on wgmma")
    return card


def hgmma_counts(paths):
    """Tensor-core (wgmma) instructions in each built library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(Path(tool).is_file(), "cuobjdump not found")
    counts = {}
    for name, path in sorted(paths.items()):
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, timeout=300)
        check(sass.returncode == 0, f"cuobjdump {name}: {sass.stderr[-500:]}")
        counts[name] = sum(" HGMMA." in line
                           for line in sass.stdout.splitlines())
    return counts


# ---------------------------------------------------------------- phase 2
def _rand(torch, gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _close(torch, got, want, dtype_name):
    got, want = got.float(), want.float()
    tol = TOL[dtype_name]
    err = (got - want).abs()
    ok = bool((err <= tol + tol * want.abs()).all()) \
        and bool(torch.isfinite(got).all())
    return ok, float(err.max()) if err.numel() else 0.0


def flash_cases():
    # (B, S, H, KV, dh, lengths, window)
    yield 2, 64, 8, 2, 32, (64, 29), None          # test_kernel_backends
    yield 2, 64, 8, 2, 32, (64, 29), 24
    for S in (16, 128, 512, 2048):                # main path: H32 KV8 dh128
        yield 1, S, 32, 8, 128, (S - S // 4 - 1,), None
    yield 1, 512, 32, 8, 128, (400,), 128          # a sliding window
    for S in (16, 32, 64, 128, 256):              # the serve's prefill chunks
        yield 1, S, 32, 8, 128, (S,), None
    for S in (16, 64, 256):                       # a rank's heads at tp = 2
        yield 1, S, 32 // TP, 8 // TP, 128, (S - S // 4 - 1,), None
    for S, n in ((256, 256), (256, 219), (16, 16)):  # zamba2: G = 1, dh 64
        yield 1, S, 32, 32, 64, (n,), None


#: the verify shape's starts (no page edge) and a batch on page edges
VERIFY_STARTS = (1, 63, 300, 511, 777, 1031, 1500, 2043)
VERIFY_EDGE_STARTS = (64, 128, 0, 640, 1984, 2040, 704, 1024)


def paged_cases():
    # (B, S or None for decode, H, KV, dh, ps, maxp, start, lengths, window)
    yield 4, None, 4, 2, 16, 16, 4, None, (1, 16, 17, 64), None
    yield 3, 12, 4, 2, 16, 8, 6, (5, 8, 0), (17, 20, 12), None
    yield 3, 12, 4, 2, 16, 8, 6, (5, 8, 0), (17, 20, 12), 7
    # main path: decode at B=8 (one full slot: length == capacity + 1,
    # not compared) and an extend chunk of 256 from a mid-page start
    yield (8, None, 32, 8, 128, 64, 32, None,
           (1, 64, 65, 300, 777, 1024, 2048, 2049), None)
    yield 1, 256, 32, 8, 128, 64, 32, (293,), (293 + 200,), None
    # groups of 3, 9, 8 and 1 query heads per kv-head (granite-moe-3b,
    # starcoder2-7b, chameleon-34b, qwen1.5-32b); decodes over many splits
    # with a window whose edge falls inside one
    yield 5, None, 6, 2, 64, 16, 24, None, (1, 16, 17, 200, 384), 150
    yield 3, None, 36, 4, 128, 64, 32, None, (65, 1056, 2048), 700
    yield 2, None, 64, 8, 128, 64, 32, None, (1500, 2049), None
    yield 3, 12, 6, 2, 16, 8, 6, (5, 8, 0), (17, 20, 12), None
    yield 2, 100, 36, 4, 128, 64, 8, (29, 64), (129, 164), 50
    yield 2, 64, 40, 40, 128, 16, 12, (0, 77), (64, 141), None
    # speculative verify at k = 4 on a full batch of llama3.1-8b (S = 5):
    # ragged starts 1..2043, then starts on page edges with two rows that
    # verify fewer than 5 tokens (the tail clamp)
    yield (8, 5, 32, 8, 128, 64, 32, VERIFY_STARTS,
           tuple(st + 5 for st in VERIFY_STARTS), None)
    yield (8, 5, 32, 8, 128, 64, 32, VERIFY_EDGE_STARTS,
           tuple(st + n for st, n in zip(VERIFY_EDGE_STARTS,
                                         (5, 5, 5, 2, 5, 5, 1, 5))), None)
    # a rank's heads at tp = 2 (H16 KV4, G = 4 as at tp = 1): the serve's
    # decode and extend, the pools holding the rank's KV heads only
    yield (8, None, 32 // TP, 8 // TP, 128, 64, 32, None,
           (1, 64, 65, 300, 777, 1024, 2048, 2049), None)
    yield 1, 256, 32 // TP, 8 // TP, 128, 64, 32, (293,), (293 + 200,), None
    # and the rank's verify at k = 4 (phase 6's tp = 2 spec serve)
    yield (8, 5, 32 // TP, 8 // TP, 128, 64, 32, VERIFY_STARTS,
           tuple(st + 5 for st in VERIFY_STARTS), None)
    # zamba2-1.2b's shared attention (H32 KV32 dh64, G = 1): decode over
    # the ragged lengths above, and a 256-token chunk from a mid-page start
    # across page edges, full and with a short real tail
    yield (8, None, 32, 32, 64, 64, 32, None,
           (1, 64, 65, 300, 777, 1024, 2048, 2049), None)
    yield 1, 256, 32, 32, 64, 64, 32, (293,), (293 + 256,), None
    yield 1, 256, 32, 32, 64, 64, 32, (293,), (293 + 200,), None


def gmm_cases():
    # (E, C, d, f, group sizes or None for random 0..C)
    for E, C, d, f in ((4, 64, 32, 16), (8, 128, 16, 64), (2, 32, 128, 8)):
        yield E, C, d, f, None                    # tests/test_kernels.py
    yield 4, 48, 32, 24, (48, 0, 5, 17)           # full, empty, tiny, partial
    yield 3, 7, 20, 13, None                      # rows not 16-byte multiples
    yield 2, 5, 512, 64, (5, 3)                   # few blocks, long d
    yield 4, 100, 256, 64, (100, 64, 65, 0)       # C over one N tile of 64
    # main path (phimini-moe): gate/up and down at every capacity, decode
    # (C = 1) to a 256-token chunk (C = 40)
    for d, f in ((4096, 960), (960, 4096)):
        for C in (1, 2, 5, 10, 20, 40):
            yield 16, C, d, f, None
    # a rank's experts at tp = 2 (expert parallel: E16 -> E8)
    for d, f in ((4096, 960), (960, 4096)):
        for C in (1, 10, 40):
            yield 16 // TP, C, d, f, None


def gmm_bwd_cases():
    # (E, C, d, f, group sizes or None for gmm_bwd_vs_plain's pattern): a K
    # stage of 64 rows and one row past it, partial d and f tiles, widths
    # off 8 (no TMA), a serve chunk, phimini-moe's training step (C = 320,
    # gate/up and down), granite-moe-3b's (E40, top-8: C = 512); for the
    # persistent grid one expert of 1024 rows (fewer tiles than SMs),
    # every group 0 (every tile skipped, dw all zero) and groups at the
    # edges of the 128-row tiles
    yield 6, 65, 64, 128, None
    yield 3, 130, 72, 200, None
    yield 2, 9, 20, 13, None
    yield 16, 40, 4096, 960, None
    yield 16, 320, 4096, 960, None
    yield 16, 320, 960, 4096, None
    yield 40, 512, 1536, 512, None
    yield 1, 1024, 256, 384, (1024,)
    yield 4, 64, 128, 192, (0, 0, 0, 0)
    yield 3, 320, 256, 192, (127, 128, 129)


def gmm_bwd_vs_plain(torch, ops, dev, worst):
    """The grouped matmul's backward kernels against their plain version:
    a case's own group sizes, or C, 0, 1, 63, 64 and 65 on the first
    experts (clipped to C) and random after; NaN in x's and dy's rows past
    each group, which must take no part; dx's rows there exactly 0, and dw
    exactly 0 where every group is empty; two launches the same bits."""
    gen = torch.Generator(device=dev).manual_seed(4)
    print("phase 2: grouped matmul backward (dx, dw) vs its plain version "
          "(max abs err | tolerance, as above; rows past a group NaN in x "
          "and dy)")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for E, C, d, f, sizes in gmm_bwd_cases():
            x = _rand(torch, gen, (E, C, d), dtype, dev)
            w = (torch.randn((E, d, f), generator=gen, device=dev)
                 * d ** -0.5).to(dtype)
            dy = _rand(torch, gen, (E, C, f), dtype, dev)
            g = torch.randint(0, C + 1, (E,), generator=gen, device=dev)
            for e, n in enumerate(sizes or (C, 0, 1, 63, 64, 65)[:E]):
                g[e] = min(n, C)
            g = g.to(torch.int32)
            past = torch.arange(C, device=dev)[None, :] >= g[:, None]
            x[past] = float("nan")
            dy[past] = float("nan")
            got = ops.moe_gmm_bwd(x, w, g, dy)
            again = ops.moe_gmm_bwd(x, w, g, dy)
            torch.cuda.synchronize()
            tag = f"({dn}, E{E} C{C} d{d} f{f})"
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"moe_gmm_bwd {tag}: two launches differ")
            want = ops.moe_gmm_bwd_plain(x, w, g, dy)
            errs = []
            for name, a, b in zip(("dx", "dw"), got, want):
                ok, err = _close(torch, a, b, dn)
                errs.append(err)
                check(ok, f"moe_gmm_bwd {name} disagrees with its plain "
                          f"version {tag}: {err}")
            zeros = not bool(got[0][past].any())
            check(zeros, f"moe_gmm_bwd {tag}: dx rows past a group not 0")
            if sizes is not None and not any(sizes):
                check(not bool(got[1].any()),
                      f"moe_gmm_bwd {tag}: dw of empty groups not 0")
            worst["moe_gmm_bwd"] = max(worst["moe_gmm_bwd"], *errs)
            print(f"  moe_gmm_bwd {dn} E{E} C{C} d{d} f{f} groups"
                  f"{g.tolist() if E <= 8 else int(g.sum())}: dx "
                  f"{errs[0]:.3g} dw {errs[1]:.3g} | {TOL[dn]}; dx rows "
                  f"past a group all 0: {zeros}")
            del x, w, dy, got, again, want
        torch.cuda.empty_cache()


def flash_bwd_cases():
    # (B, S, H, KV, dh, lengths, window): demo-110m's heads (G = 3) at S
    # 128 and its training length 1024, llama3.1-8b's (G = 4) at 1024,
    # musicgen-large's (G = 1), a window shorter than S, ragged lengths
    # (dout zero past a length), S not a multiple of the tiles (100), and
    # head dims 16 and 32
    yield 2, 128, 12, 4, 64, None, None
    yield 2, 1024, 12, 4, 64, None, None
    yield 1, 1024, 32, 8, 128, None, None
    yield 2, 256, 32, 32, 64, None, None
    yield 2, 512, 12, 4, 64, None, 100
    yield 3, 256, 12, 4, 64, (256, 131, 17), 64
    yield 2, 100, 8, 2, 16, (100, 57), None
    yield 2, 160, 8, 4, 32, None, 33
    # the edges of the bf16 kernels' 64-row tiles: S = 65 and 129 (one row
    # into the next tile; a length of 100), a window of exactly 64, and
    # G = 3 at dh 16 with a length on a tile edge
    yield 2, 65, 12, 4, 64, None, None
    yield 1, 129, 32, 8, 128, (100,), None
    yield 2, 256, 8, 2, 32, (256, 190), 64
    yield 2, 129, 6, 2, 16, (129, 64), None


def flash_bwd_vs_plain(torch, ops, dev, worst):
    """The forward's lse and the backward kernel's dq, dk, dv against
    their plain versions on the same inputs (the kernel's own out and
    lse), and two launches of each giving the same bits."""
    gen = torch.Generator(device=dev).manual_seed(2)
    print("phase 2: flash backward (dq, dk, dv) and the forward's lse vs "
          "their plain versions (max abs err | tolerance, as above; rows "
          "an engine reads: lse and dout past a length are not compared "
          "and zero)")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for B, S, H, KV, dh, lengths, window in flash_bwd_cases():
            q = _rand(torch, gen, (B, S, H, dh), dtype, dev)
            k = _rand(torch, gen, (B, S, KV, dh), dtype, dev)
            v = _rand(torch, gen, (B, S, KV, dh), dtype, dev)
            do = _rand(torch, gen, (B, S, H, dh), dtype, dev)
            n = [S] * B if lengths is None else list(lengths)
            for b in range(B):
                do[b, n[b]:] = 0
            lt = torch.tensor(n, dtype=torch.int32, device=dev)
            out, lse = ops.flash_attention(q, k, v, lt, window,
                                           return_lse=True)
            out2, lse2 = ops.flash_attention(q, k, v, lt, window,
                                             return_lse=True)
            _, plse = ops.flash_attention_plain(q, k, v, lt, window,
                                                return_lse=True)
            got = ops.flash_attention_bwd(q, k, v, out, lse, do, lt, window)
            again = ops.flash_attention_bwd(q, k, v, out, lse, do, lt,
                                            window)
            torch.cuda.synchronize()
            tag = f"({dn}, B{B} S{S} H{H} KV{KV} dh{dh}, window={window})"
            check(torch.equal(out, out2) and torch.equal(lse, lse2),
                  f"flash_attention with lse {tag}: two launches differ")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash_attention_bwd {tag}: two launches differ")
            ok, err_lse = True, 0.0
            for b in range(B):
                o, e = _close(torch, lse[b, :, :n[b]], plse[b, :, :n[b]],
                              dn)
                ok, err_lse = ok and o, max(err_lse, e)
            check(ok, f"flash_attention lse disagrees with its plain "
                      f"version {tag}: {err_lse}")
            want = ops.flash_attention_bwd_plain(q, k, v, out, lse, do, lt,
                                                 window)
            errs = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                o, e = _close(torch, g, w, dn)
                errs.append(e)
                check(o, f"flash_attention_bwd {name} disagrees with its "
                         f"plain version {tag}: {e}")
            worst["flash_attention"] = max(worst["flash_attention"],
                                           err_lse)
            worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"],
                                               *errs)
            print(f"  flash_bwd {dn} B{B} S{S} H{H} KV{KV} dh{dh} "
                  f"len{tuple(n)} win{window}: dq {errs[0]:.3g} dk "
                  f"{errs[1]:.3g} dv {errs[2]:.3g}, lse {err_lse:.3g} | "
                  f"{TOL[dn]}")
            del q, k, v, do, out, lse, got, again, want
        torch.cuda.empty_cache()


def kernels_vs_plain(torch, ops, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {k: 0.0 for k in ops.KERNELS}
    print("phase 2: kernel vs plain version (max abs err | tolerance; "
          "f32 1e-4: the two sum in other orders; bf16 2e-2: inputs and "
          "outputs round to 8 mantissa bits); every kernel also bitwise "
          "equal over two launches")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for B, S, H, KV, dh, lengths, window in flash_cases():
            q = _rand(torch, gen, (B, S, H, dh), dtype, dev)
            k = _rand(torch, gen, (B, S, KV, dh), dtype, dev)
            v = _rand(torch, gen, (B, S, KV, dh), dtype, dev)
            lt = torch.tensor(lengths, dtype=torch.int32, device=dev)
            got = ops.flash_attention(q, k, v, lt, window)
            again = ops.flash_attention(q, k, v, lt, window)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"flash_attention ({dn}, S={S}, "
                                           f"window={window}): two launches "
                                           f"differ")
            want = ops.flash_attention_plain(q, k, v, lt, window)
            ok, err = True, 0.0
            for b, n in enumerate(lengths):      # rows an engine reads
                o, e = _close(torch, got[b, :n], want[b, :n], dn)
                ok, err = ok and o, max(err, e)
            worst["flash_attention"] = max(worst["flash_attention"], err)
            print(f"  flash {dn} B{B} S{S} H{H} KV{KV} dh{dh} "
                  f"len{lengths} win{window}: {err:.3g} | {TOL[dn]}")
            check(ok, f"flash_attention disagrees with its plain version "
                      f"({dn}, S={S}, window={window}): {err}")
        for (B, S, H, KV, dh, ps, maxp, start, lengths,
             window) in paged_cases():
            P = B * maxp + 1
            qs = (B, H, dh) if S is None else (B, S, H, dh)
            q = _rand(torch, gen, qs, dtype, dev)
            kp = _rand(torch, gen, (P, ps, KV, dh), dtype, dev)
            vp = _rand(torch, gen, (P, ps, KV, dh), dtype, dev)
            table = torch.randperm(P - 1, generator=gen, device=dev)[
                :B * maxp].reshape(B, maxp).to(torch.int32)
            lt = torch.tensor(lengths, dtype=torch.int32, device=dev)
            st = None if start is None else torch.tensor(
                start, dtype=torch.int32, device=dev)
            got = ops.paged_attention(q, kp, vp, table, lt, page_size=ps,
                                      start=st, window=window)
            again = ops.paged_attention(q, kp, vp, table, lt, page_size=ps,
                                        start=st, window=window)
            torch.cuda.synchronize()
            name = "paged_attention_decode" if S is None \
                else "paged_attention_extend"
            check(torch.equal(got, again), f"{name} ({dn}, H{H} KV{KV}, "
                                           f"lengths={lengths}): two "
                                           f"launches differ")
            want = ops.paged_attention_plain(q, kp, vp, table, lt,
                                             page_size=ps, start=st,
                                             window=window)
            ok, err = True, 0.0
            for b, n in enumerate(lengths):
                if S is None:
                    if n > maxp * ps:    # an unscheduled full slot
                        check(bool(torch.isfinite(got[b]).all()),
                              "paged decode: full-slot row not finite")
                        continue
                    o, e = _close(torch, got[b], want[b], dn)
                else:                    # the chunk's real rows
                    o, e = _close(torch, got[b, :n - start[b]],
                                  want[b, :n - start[b]], dn)
                ok, err = ok and o, max(err, e)
            worst[name] = max(worst[name], err)
            print(f"  {name} {dn} B{B} S{S} H{H} KV{KV} dh{dh} ps{ps} "
                  f"maxp{maxp} len{lengths} win{window}: {err:.3g} | "
                  f"{TOL[dn]}")
            check(ok, f"{name} disagrees with its plain version ({dn}, "
                      f"lengths={lengths}): {err}")
        for E, C, d, f, gs in gmm_cases():
            x = _rand(torch, gen, (E, C, d), dtype, dev)
            # fan-in scaled weights, as the model's: unit-scale outputs, so
            # f32 sums over d = 4096 in two orders agree within 1e-4
            w = (torch.randn((E, d, f), generator=gen, device=dev)
                 * d ** -0.5).to(dtype)
            g = torch.randint(0, C + 1, (E,), generator=gen, device=dev) \
                if gs is None else torch.tensor(gs, device=dev)
            g = g.to(torch.int32)
            got = ops.moe_gmm(x, w, g)
            again = ops.moe_gmm(x, w, g)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"moe_gmm ({dn}, E{E} C{C} d{d} "
                                           f"f{f}): two launches differ")
            want = ops.moe_gmm_plain(x, w, g)
            ok, err = _close(torch, got, want, dn)
            past = torch.arange(C, device=dev)[None, :] >= g[:, None]
            zeros = not bool(got[past].any())
            worst["moe_gmm"] = max(worst["moe_gmm"], err)
            print(f"  moe_gmm {dn} E{E} C{C} d{d} f{f} "
                  f"groups{g.tolist() if E <= 8 else int(g.sum())}: "
                  f"{err:.3g} | {TOL[dn]}; rows past a group all 0: {zeros}")
            check(ok and zeros, f"moe_gmm disagrees with its plain version "
                                f"({dn}, E{E} C{C} d{d} f{f}): {err}, "
                                f"rows past a group 0: {zeros}")
    flash_bwd_vs_plain(torch, ops, dev, worst)
    gmm_bwd_vs_plain(torch, ops, dev, worst)
    return worst


# ---------------------------------------------------------------- phase 3
def time_ms(torch, fn, reps=20, warm=3):
    """Median of ``reps`` CUDA-event timings of ``fn``, with L2 flushed
    (a 256 MB write) before each, as a layer's caller finds its inputs.
    The card then spins for about 0.1 ms, so the host has issued all of
    ``fn`` before the first event is reached: what is timed is the card's
    work for the call, not the host's (``host_us`` times that)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(200_000)     # clock cycles
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(torch, fn, n=100):
    """Host time to issue one call of ``fn`` (checks, allocation, launch),
    averaged over ``n`` calls issued back to back: the cost a host-bound
    serve pays per launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def bound(work):
    """(ms, what binds) of a kernel call's (FLOPs, bytes), from its work
    count in ``ops`` (the dry run's counter charges the same)."""
    flops, nbytes = work
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def timings(torch, ops, dev):
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    H, KV, dh, ps, maxp = 32, 8, 128, 64, 32
    G = H // KV
    out = {}

    def measure(call, plain, library, **row):
        return dict(row, ms=time_ms(torch, call),
                    plain_ms=time_ms(torch, plain),
                    library_ms=time_ms(torch, library),
                    host_us=host_us(torch, call))

    # flash: one prefill chunk of the main path (B=1, S=256, full length)
    S = 256
    q = _rand(torch, gen, (1, S, H, dh), bf, dev)
    k = _rand(torch, gen, (1, S, KV, dh), bf, dev)
    v = _rand(torch, gen, (1, S, KV, dh), bf, dev)
    lt = torch.tensor([S], dtype=torch.int32, device=dev)
    work = ops.flash_attention_work(1, S, H, KV, dh, 2,
                                    ops.causal_pairs(S, [S], None))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out["flash_attention"] = measure(
        lambda: ops.flash_attention(q, k, v, lt),
        lambda: ops.flash_attention_plain(q, k, v, lt),
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True),
        shape=f"B1 S{S} H{H} KV{KV} dh{dh} bf16",
        bound=bound(work))

    def paged_library(q4, kp, vp, table, lengths, start):
        """Gather the pages, then SDPA under the paged mask."""
        B, Sq = q4.shape[:2]
        kv, d = kp.shape[-2:]
        kg = kp[table.reshape(-1).long()].reshape(B, maxp * ps, kv, d)
        vg = vp[table.reshape(-1).long()].reshape(B, maxp * ps, kv, d)
        qpos = start.long()[:, None] + torch.arange(Sq, device=dev)
        kvpos = torch.arange(maxp * ps, device=dev)
        mask = (kvpos[None, None] <= qpos[..., None]) & \
            (kvpos[None, None] < lengths.long()[:, None, None])
        return F.scaled_dot_product_attention(
            q4.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
            attn_mask=mask[:, None], enable_gqa=True)

    # decode: B=8 rows at the serve's context lengths
    B = 8
    P = B * maxp + 1
    kp = _rand(torch, gen, (P, ps, KV, dh), bf, dev)
    vp = _rand(torch, gen, (P, ps, KV, dh), bf, dev)
    table = torch.randperm(P - 1, generator=gen, device=dev)[
        :B * maxp].reshape(B, maxp).to(torch.int32)
    lens = (97, 180, 333, 512, 640, 781, 900, 1056)
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    qd = _rand(torch, gen, (B, H, dh), bf, dev)
    from repro_torch.kernels import build
    lib = build.load("paged_attention")
    print(f"phase 3: paged decode takes "
          f"{lib.paged_decode_pages_per_split()} pages per split: "
          f"{lib.paged_decode_splits(maxp)} splits for {maxp} pages a table")
    kv_rows = sum(lens)
    out["paged_attention_decode"] = measure(
        lambda: ops.paged_attention(qd, kp, vp, table, lt, page_size=ps),
        lambda: ops.paged_attention_plain(qd, kp, vp, table, lt,
                                          page_size=ps),
        lambda: paged_library(qd[:, None], kp, vp, table, lt, lt - 1),
        shape=f"B{B} H{H} KV{KV} dh{dh} ps{ps} len{lens} bf16",
        bound=bound(ops.paged_decode_work(B, H, KV, dh, 2, table.numel(),
                                          kv_rows)))

    # extend: one 256-token chunk from a mid-page start (B=1)
    S, start = 256, 293
    qe = _rand(torch, gen, (1, S, H, dh), bf, dev)
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    lt = st + S
    rows, pairs = ops.paged_work([start], S, [start + S], None)
    work = ops.paged_extend_work(1, S, H, KV, dh, 2, maxp, rows, pairs)
    out["paged_attention_extend"] = measure(
        lambda: ops.paged_attention(qe, kp, vp, table[:1], lt,
                                    page_size=ps, start=st),
        lambda: ops.paged_attention_plain(qe, kp, vp, table[:1], lt,
                                          page_size=ps, start=st),
        lambda: paged_library(qe, kp, vp, table[:1], lt, st),
        shape=f"B1 S{S} start{start} H{H} KV{KV} dh{dh} ps{ps} bf16",
        bound=bound(work))

    # grouped matmul: gate/up (d 4096 -> f 960) and down (960 -> 4096), each
    # at a 256-token chunk (C = 40) and at batch-8 decode (C = 1), group
    # sizes from a uniform top-2 router over 16 experts; the bound counts
    # only what this data needs (active experts' weights, rows inside the
    # groups)
    E, k = 16, 2
    for C, T in ((40, 256), (1, 8)):
        pick = torch.rand((T, E), generator=gen, device=dev).argsort(-1)[
            :, :k]
        counts = torch.bincount(pick.reshape(-1), minlength=E)
        gs = torch.clamp(counts, max=C).to(torch.int32)
        rows = int(gs.sum())
        active = int((gs > 0).sum())
        mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
        for d, f, part in ((4096, 960, ""), (960, 4096, "_down")):
            x = _rand(torch, gen, (E, C, d), bf, dev)
            w = _rand(torch, gen, (E, d, f), bf, dev)
            name = "moe_gmm" + part + ("" if C == 40 else "_decode")
            out[name] = measure(
                lambda: ops.moe_gmm(x, w, gs),
                lambda: ops.moe_gmm_plain(x, w, gs),
                lambda: torch.bmm(x, w).mul_(mask),
                kernel="moe_gmm",
                shape=f"E{E} C{C} d{d} f{f} bf16, {active} experts active, "
                      f"{rows} rows",
                bound=bound(ops.moe_gmm_work(E, C, d, f, 2, rows, active)))
    # verify: the extend kernel at speculative decoding's k = 4 check of a
    # full batch (B = 8, S = 5) from the ragged starts of phase 2, on the
    # decode's pools (timed last, so the other rows' draws stay as they
    # were); its launches are those of the full-width spec serve
    S = 5
    st = torch.tensor(VERIFY_STARTS, dtype=torch.int32, device=dev)
    lt = st + S
    qv = _rand(torch, gen, (B, S, H, dh), bf, dev)
    rows, pairs = ops.paged_work(VERIFY_STARTS, S,
                                 [s0 + S for s0 in VERIFY_STARTS], None)
    work = ops.paged_extend_work(B, S, H, KV, dh, 2, table.numel(), rows,
                                 pairs)
    out["paged_attention_verify"] = measure(
        lambda: ops.paged_attention(qv, kp, vp, table, lt, page_size=ps,
                                    start=st),
        lambda: ops.paged_attention_plain(qv, kp, vp, table, lt,
                                          page_size=ps, start=st),
        lambda: paged_library(qv, kp, vp, table, lt, st),
        kernel="paged_attention_extend", path=SPEC_PATH,
        shape=f"B{B} S{S} starts{VERIFY_STARTS} H{H} KV{KV} dh{dh} "
              f"ps{ps} bf16",
        bound=bound(work))

    # a rank's shapes at tp = 2 (phase 6's serves): 16 query and 4 KV
    # heads, the serve's prefill chunk, decode and extend, and phimini-moe's
    # experts E16 -> E8 (rank 0's share of uniform top-2 groups); their own
    # generator, so the rows above keep their draws; launches from phase 6
    gen = torch.Generator(device=dev).manual_seed(2)
    H2, KV2, S = H // TP, KV // TP, 256
    q2 = _rand(torch, gen, (1, S, H2, dh), bf, dev)
    k2 = _rand(torch, gen, (1, S, KV2, dh), bf, dev)
    v2 = _rand(torch, gen, (1, S, KV2, dh), bf, dev)
    lt2 = torch.tensor([S], dtype=torch.int32, device=dev)
    work = ops.flash_attention_work(1, S, H2, KV2, dh, 2,
                                    ops.causal_pairs(S, [S], None))
    qt, kt, vt = (x.transpose(1, 2) for x in (q2, k2, v2))
    out["flash_attention_tp2"] = measure(
        lambda: ops.flash_attention(q2, k2, v2, lt2),
        lambda: ops.flash_attention_plain(q2, k2, v2, lt2),
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True),
        kernel="flash_attention", path=TP2_PATH,
        shape=f"B1 S{S} H{H2} KV{KV2} dh{dh} bf16",
        bound=bound(work))
    kp2 = _rand(torch, gen, (P, ps, KV2, dh), bf, dev)
    vp2 = _rand(torch, gen, (P, ps, KV2, dh), bf, dev)
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    qd = _rand(torch, gen, (B, H2, dh), bf, dev)
    out["paged_attention_decode_tp2"] = measure(
        lambda: ops.paged_attention(qd, kp2, vp2, table, lt, page_size=ps),
        lambda: ops.paged_attention_plain(qd, kp2, vp2, table, lt,
                                          page_size=ps),
        lambda: paged_library(qd[:, None], kp2, vp2, table, lt, lt - 1),
        kernel="paged_attention_decode", path=TP2_PATH,
        shape=f"B{B} H{H2} KV{KV2} dh{dh} ps{ps} len{lens} bf16",
        bound=bound(ops.paged_decode_work(B, H2, KV2, dh, 2, table.numel(),
                                          kv_rows)))
    S, start = 256, 293
    qe = _rand(torch, gen, (1, S, H2, dh), bf, dev)
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    lt = st + S
    rows, pairs = ops.paged_work([start], S, [start + S], None)
    work = ops.paged_extend_work(1, S, H2, KV2, dh, 2, maxp, rows, pairs)
    out["paged_attention_extend_tp2"] = measure(
        lambda: ops.paged_attention(qe, kp2, vp2, table[:1], lt,
                                    page_size=ps, start=st),
        lambda: ops.paged_attention_plain(qe, kp2, vp2, table[:1], lt,
                                          page_size=ps, start=st),
        lambda: paged_library(qe, kp2, vp2, table[:1], lt, st),
        kernel="paged_attention_extend", path=TP2_PATH,
        shape=f"B1 S{S} start{start} H{H2} KV{KV2} dh{dh} ps{ps} bf16",
        bound=bound(work))
    E2 = E // TP
    for C, T in ((40, 256), (1, 8)):
        pick = torch.rand((T, E), generator=gen, device=dev).argsort(-1)[
            :, :k]
        counts = torch.bincount(pick.reshape(-1), minlength=E)[:E2]
        gs = torch.clamp(counts, max=C).to(torch.int32)
        rows = int(gs.sum())
        active = int((gs > 0).sum())
        mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
        for d, f, part in ((4096, 960, ""), (960, 4096, "_down")):
            x = _rand(torch, gen, (E2, C, d), bf, dev)
            w = _rand(torch, gen, (E2, d, f), bf, dev)
            name = "moe_gmm" + part + "_tp2" + ("" if C == 40 else "_decode")
            out[name] = measure(
                lambda: ops.moe_gmm(x, w, gs),
                lambda: ops.moe_gmm_plain(x, w, gs),
                lambda: torch.bmm(x, w).mul_(mask),
                kernel="moe_gmm", path=TP2_MOE_PATH,
                shape=f"E{E2} C{C} d{d} f{f} bf16, {active} experts active, "
                      f"{rows} rows",
                bound=bound(ops.moe_gmm_work(E2, C, d, f, 2, rows, active)))
    # verify at the rank's heads (phase 6's tp = 2 spec serve): B8 S5 from
    # the verify row's ragged starts, on the rank's pools (drawn last, so
    # the rank's rows above keep their draws)
    S = 5
    st = torch.tensor(VERIFY_STARTS, dtype=torch.int32, device=dev)
    lt = st + S
    qv2 = _rand(torch, gen, (B, S, H2, dh), bf, dev)
    rows, pairs = ops.paged_work(VERIFY_STARTS, S,
                                 [s0 + S for s0 in VERIFY_STARTS], None)
    work = ops.paged_extend_work(B, S, H2, KV2, dh, 2, table.numel(), rows,
                                 pairs)
    out["paged_attention_verify_tp2"] = measure(
        lambda: ops.paged_attention(qv2, kp2, vp2, table, lt, page_size=ps,
                                    start=st),
        lambda: ops.paged_attention_plain(qv2, kp2, vp2, table, lt,
                                          page_size=ps, start=st),
        lambda: paged_library(qv2, kp2, vp2, table, lt, st),
        kernel="paged_attention_extend", path=TP2_SPEC_PATH,
        shape=f"B{B} S{S} starts{VERIFY_STARTS} H{H2} KV{KV2} dh{dh} "
              f"ps{ps} bf16",
        bound=bound(work))
    # zamba2-1.2b's shared attention (phase 7's serve): H32 KV32 dh64, one
    # query head per kv-head; the same chunk, decode and extend shapes as
    # llama's rows, their own generator; launches from the zamba2 serve
    gen = torch.Generator(device=dev).manual_seed(3)
    Hz = KVz = 32
    dz, S = 64, 256
    q = _rand(torch, gen, (1, S, Hz, dz), bf, dev)
    k = _rand(torch, gen, (1, S, KVz, dz), bf, dev)
    v = _rand(torch, gen, (1, S, KVz, dz), bf, dev)
    lt = torch.tensor([S], dtype=torch.int32, device=dev)
    work = ops.flash_attention_work(1, S, Hz, KVz, dz, 2,
                                    ops.causal_pairs(S, [S], None))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out["flash_attention_zamba"] = measure(
        lambda: ops.flash_attention(q, k, v, lt),
        lambda: ops.flash_attention_plain(q, k, v, lt),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        kernel="flash_attention", path=ZAMBA_PATH,
        shape=f"B1 S{S} H{Hz} KV{KVz} dh{dz} bf16",
        bound=bound(work))
    kpz = _rand(torch, gen, (P, ps, KVz, dz), bf, dev)
    vpz = _rand(torch, gen, (P, ps, KVz, dz), bf, dev)
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    qd = _rand(torch, gen, (B, Hz, dz), bf, dev)
    out["paged_attention_decode_zamba"] = measure(
        lambda: ops.paged_attention(qd, kpz, vpz, table, lt, page_size=ps),
        lambda: ops.paged_attention_plain(qd, kpz, vpz, table, lt,
                                          page_size=ps),
        lambda: paged_library(qd[:, None], kpz, vpz, table, lt, lt - 1),
        kernel="paged_attention_decode", path=ZAMBA_PATH,
        shape=f"B{B} H{Hz} KV{KVz} dh{dz} ps{ps} len{lens} bf16",
        bound=bound(ops.paged_decode_work(B, Hz, KVz, dz, 2, table.numel(),
                                          kv_rows)))
    start = 293
    qe = _rand(torch, gen, (1, S, Hz, dz), bf, dev)
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    lt = st + S
    rows, pairs = ops.paged_work([start], S, [start + S], None)
    work = ops.paged_extend_work(1, S, Hz, KVz, dz, 2, maxp, rows, pairs)
    out["paged_attention_extend_zamba"] = measure(
        lambda: ops.paged_attention(qe, kpz, vpz, table[:1], lt,
                                    page_size=ps, start=st),
        lambda: ops.paged_attention_plain(qe, kpz, vpz, table[:1], lt,
                                          page_size=ps, start=st),
        lambda: paged_library(qe, kpz, vpz, table[:1], lt, st),
        kernel="paged_attention_extend", path=ZAMBA_PATH,
        shape=f"B1 S{S} start{start} H{Hz} KV{KVz} dh{dz} ps{ps} bf16",
        bound=bound(work))
    out.update(flash_bwd_timings(torch, ops, dev, measure))
    out.update(gmm_train_timings(torch, ops, dev, measure))
    print("phase 3: times (median of 20, L2 flushed; ms) and the host's "
          "time to issue one kernel call (us)")
    for name, t in out.items():
        t.setdefault("kernel", name)
        print(f"  {name} [{t['shape']}]: kernel {t['ms']:.4f}, plain "
              f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f} "
              f"(kernel / library {t['ms'] / t['library_ms']:.2f}), "
              f"bound {t['bound'][0]:.4f} ({t['bound'][1]}); host "
              f"{t['host_us']:.1f} us a call"
              + ("; device dx {dx:.4f}, dw {dw:.4f}".format(**t["split_ms"])
                 if "split_ms" in t else ""))
    return out


#: the training phase's paths (launch counts by path)
TRAIN_PATH = "train demo-110m"
TRAIN_LLAMA_PATH = "train llama3.1-8b (2 layers)"
TRAIN_MUSICGEN_PATH = "train musicgen-large (4 layers)"
TRAIN_MOE_PATH = "train phimini-moe (2 layers)"


def flash_bwd_timings(torch, ops, dev, measure):
    """The flash backward at demo-110m's training step (B8 S1024 H12 KV4
    dh64) and llama3.1-8b's (B2 S1024 H32 KV8 dh128), bf16, beside its
    plain version and autograd through SDPA with K/V expanded to every
    query head (the library call; the port never makes it).

    The bound: bytes of q, k, v, out, dout (bf16), lse (f32), dq, dk, dv
    (bf16), each once, over 3.35 TB/s, against the FA-2 backward's five
    products per visible (query, key) pair (S = QK^T recomputed, dP =
    dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K), 2 * dh FLOPs each,
    over the bf16 tensor-core peak: 10 * dh * B * H * S (S + 1) / 2
    (causal, full lengths).  The bf16 kernel runs two passes on wgmma fed
    by TMA (dK/dV per 64-key tile, dQ per 64-row query tile, no atomics),
    14 * dh FLOPs a pair (S and dP in both passes): its floor is 1.4x the
    bound."""
    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    rows = {}
    for name, B, S, H, KV, dh, path in (
            ("flash_attention_bwd", 8, 1024, 12, 4, 64, TRAIN_PATH),
            ("flash_attention_bwd_llama", 2, 1024, 32, 8, 128,
             TRAIN_LLAMA_PATH)):
        q = _rand(torch, gen, (B, S, H, dh), bf, dev)
        k = _rand(torch, gen, (B, S, KV, dh), bf, dev)
        v = _rand(torch, gen, (B, S, KV, dh), bf, dev)
        do = _rand(torch, gen, (B, S, H, dh), bf, dev)
        lt = torch.full((B,), S, dtype=torch.int32, device=dev)
        out, lse = ops.flash_attention(q, k, v, lt, return_lse=True)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        ref = torch.nn.functional.scaled_dot_product_attention(
            qt, kt.repeat_interleave(H // KV, dim=1),
            vt.repeat_interleave(H // KV, dim=1), is_causal=True)
        dot = do.transpose(1, 2)
        # read q, k, v, out, dout; write dq, dk, dv (bf16); read lse (f32)
        work = ops.flash_attention_bwd_work(
            B, S, H, KV, dh, 2, ops.causal_pairs(S, [S] * B, None))
        rows[name] = measure(
            lambda: ops.flash_attention_bwd(q, k, v, out, lse, do, lt),
            lambda: ops.flash_attention_bwd_plain(q, k, v, out, lse, do, lt),
            lambda: torch.autograd.grad(ref, (qt, kt, vt), dot,
                                        retain_graph=True),
            kernel="flash_attention_bwd", path=path,
            shape=f"B{B} S{S} H{H} KV{KV} dh{dh} bf16",
            bound=bound(work))
        del q, k, v, do, out, lse, qt, kt, vt, ref
        torch.cuda.empty_cache()
    return rows


def gmm_bwd_split(torch, fn):
    """The device ms of the backward's dx kernel and of its dw kernel per
    call, from 5 calls under ``torch.profiler`` (``tools/gmm_bwd_time.py``'s
    split, by kernel name)."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import gmm_bwd_time
    finally:
        sys.path.remove(str(ROOT / "tools"))
    got = gmm_bwd_time.split(torch, fn, 5)
    check(got["dx"]["launches"] and got["dw"]["launches"],
          f"moe_gmm_bwd: no dx or dw kernel in a profiled call: {got}")
    return {part: got[part]["ms"] for part in ("dx", "dw")}


# ---------------------------------------------------------------- phase 4
def gmm_train_timings(torch, ops, dev, measure):
    """The grouped matmul and its backward at phimini-moe's training step
    (B2 S1024: 2048 tokens, a seeded uniform top-2 routing over 16 experts,
    capacity 320), gate/up (d 4096 -> f 960) and down (960 -> 4096), bf16.
    The bound counts what this data needs: the active experts' weights and
    the rows inside the groups read, every output written (the backward:
    dx (E, C, d) and dw (E, d, f)); FLOPs 2 * rows * d * f a product (the
    backward has two).  The library: ``torch.bmm`` times the row mask, and
    for the backward autograd through it (two batched GEMMs over every
    row, then the mask); the port never calls either."""
    gen = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    E, k, T = 16, 2, 2048
    C = round(T * k * 1.25 / E)
    pick = torch.rand((T, E), generator=gen, device=dev).argsort(-1)[:, :k]
    counts = torch.bincount(pick.reshape(-1), minlength=E)
    gs = torch.clamp(counts, max=C).to(torch.int32)
    rows = int(gs.sum())
    active = int((gs > 0).sum())
    mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
    out = {}
    for d, f, part in ((4096, 960, "gate_up"), (960, 4096, "down")):
        x = _rand(torch, gen, (E, C, d), bf, dev)
        w = _rand(torch, gen, (E, d, f), bf, dev) * d ** -0.5
        dy = _rand(torch, gen, (E, C, f), bf, dev)
        shape = (f"E{E} C{C} d{d} f{f} bf16, {active} experts active, "
                 f"{rows} rows")
        out[f"moe_gmm_train_{part}"] = measure(
            lambda: ops.moe_gmm(x, w, gs),
            lambda: ops.moe_gmm_plain(x, w, gs),
            lambda: torch.bmm(x, w).mul_(mask),
            kernel="moe_gmm", path=TRAIN_MOE_PATH, shape=shape,
            bound=bound(ops.moe_gmm_work(E, C, d, f, 2, rows, active)))
        xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
        ref = torch.bmm(xl, wl) * mask
        out[f"moe_gmm_bwd_{part}"] = measure(
            lambda: ops.moe_gmm_bwd(x, w, gs, dy),
            lambda: ops.moe_gmm_bwd_plain(x, w, gs, dy),
            lambda: torch.autograd.grad(ref, (xl, wl), dy,
                                        retain_graph=True),
            kernel="moe_gmm_bwd", path=TRAIN_MOE_PATH, shape=shape,
            bound=bound(ops.moe_gmm_bwd_work(E, C, d, f, 2, rows, active)),
            split_ms=gmm_bwd_split(torch,
                                   lambda: ops.moe_gmm_bwd(x, w, gs, dy)))
        del x, w, dy, xl, wl, ref
        torch.cuda.empty_cache()
    return out


def _tiny_serve(cfg, params, dev, reqs, *, max_batch=2, chunk=16,
                **engine_kw):
    """One tiny engine on ``dev`` (``engine_kw``: routing, spec,
    prefix_cache, tp and group) behind a chunked-prefill ServeDriver:
    (tokens, decisions, metrics, its InstanceCfg).  The callers' arrivals
    do not depend on latencies (all at 0, or phases far apart), so
    neither do the decisions.  A prefix store's radix tree is held to 3
    device blocks, so it spills to the host tier."""
    from repro_torch.core.config import SchedulerCfg
    from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine
    eng = ServingEngine(cfg, params, max_batch=max_batch, max_len=256,
                        name="e0", device=dev, **engine_kw)
    drv = ServeDriver([eng], DriverCfg(scheduler=SchedulerCfg(
        max_batch_size=max_batch, max_batch_tokens=64, chunked_prefill=True,
        prefill_chunk=chunk)))
    if engine_kw.get("prefix_cache"):
        for inst in drv.runtime.instances.values():
            inst.cache.capacity_blocks = 3
    m = drv.run([dataclasses.replace(r) for r in reqs], warmup=False)
    inst = drv.runtime.instances["e0"]
    check(m["finished"] == len(reqs), f"tiny {cfg.name} on {dev}: finished "
                                      f"{m['finished']} of {len(reqs)}")
    return dict(inst.backend.out_tokens), list(inst.decisions), m, inst.cfg


def _tiny_requests(vocab):
    """6 requests, every arrival at 0."""
    from repro_torch.workload import ShareGPTConfig, generate
    reqs = generate(ShareGPTConfig(
        n_requests=6, rate=50.0, vocab=vocab, seed=3, mean_prompt=60,
        mean_output=8, max_prompt=120, max_output=10, share_fraction=0.0))
    for r in reqs:
        r.arrival = 0.0
    return reqs


def _tiny_run(torch, arch, params, dev, **engine_kw):
    """Serve ``_tiny_requests`` on ``dev`` at batch 4: (tokens, decisions,
    metrics, InstanceCfg)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    return _tiny_serve(cfg, params, dev, _tiny_requests(cfg.vocab),
                       max_batch=4, chunk=32, **engine_kw)


def tiny_card_matches_cpu(torch):
    """Tiny f32 models served on the card (kernels) and on the CPU (plain
    versions) from the same weights must emit the same tokens and make the
    same decisions; the MoE one also under a replayed zipf routing trace,
    with equal expert-load counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.moe import moe_layer_count
    from repro_torch.workload.expert_skew import (SkewConfig,
                                                  synthesize_routing)
    for arch in ("llama3.1-8b-tiny", "phimini-moe-tiny"):
        cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
        params = Model(cfg).init(torch.Generator().manual_seed(0))
        runs = {dev: _tiny_run(torch, arch, params, dev)
                for dev in ("cpu", "cuda")}
        check(runs["cuda"][:2] == runs["cpu"][:2],
              f"tiny {arch}: tokens or decisions on the card differ from "
              f"the CPU")
        n_tok = sum(len(t) for t in runs["cuda"][0].values())
        print(f"phase 4: tiny {arch} f32, card == CPU: {n_tok} tokens and "
              f"{len(runs['cuda'][1])} decisions identical")
    trace = synthesize_routing(
        moe_layer_count(cfg), cfg.moe.n_experts, cfg.moe.top_k,
        SkewConfig(kind="zipf", zipf_a=1.4, period=128, seed=7),
        model=cfg.name)
    runs = {dev: _tiny_run(torch, arch, params, dev, routing=trace)
            for dev in ("cpu", "cuda")}
    loads = {dev: r[2]["expert_load"] for dev, r in runs.items()}
    check(runs["cuda"][:2] == runs["cpu"][:2]
          and loads["cuda"]["counts"] == loads["cpu"]["counts"]
          and loads["cuda"]["tokens"] > 0,
          f"tiny {arch} under a replayed trace: the card differs from the "
          f"CPU")
    print(f"phase 4: tiny {arch} f32 under a replayed zipf trace, card == "
          f"CPU: tokens, decisions and expert-load counts identical "
          f"({loads['cuda']['tokens']} tokens routed, imbalance "
          f"{loads['cuda']['imbalance']:.3f})")


def _grouped_requests(vocab):
    """Two phases of a shared-prefix workload: two requests at t = 0 fill
    the prefix store, four at t = 1e6 hit it (32-token shared prefixes,
    whole blocks; ``tests/test_torch_prefix.py``'s workload)."""
    from repro_torch.workload.sharegpt import Request
    reqs = []
    for phase, arrival in ((0, 0.0), (1, 1e6)):
        for g in range(2):
            base = [(g * 977 + j * 13) % vocab for j in range(32)]
            for k in range(1 + phase):
                tail = [(g * 53 + k * 7 + 2 + 29 * phase + j) % vocab
                        for j in range(8)]
                reqs.append(Request(req_id=len(reqs), arrival=arrival,
                                    prompt_tokens=base + tail,
                                    output_len=4))
    return reqs


def tiny_prefix_and_spec_card_matches_cpu(torch):
    """Tiny f32 llama on the card and on the CPU from the same weights:
    (a) with the prefix store on a shared-prefix workload, the same
    tokens, decisions and KV-tier counters, restores through the host
    tier; (b) speculative decoding with a perfect draft (the target's
    weights) and (c) with an unrelated draft, both emitting exactly the
    vanilla greedy tokens, with equal ``spec_decode`` counts on both
    devices; and the prefix store's device -> host -> SSD -> device round
    trip on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import SpecDecodeCfg
    from repro_torch.workload import ShareGPTConfig, generate
    cfg = dataclasses.replace(get_config("llama3.1-8b-tiny"),
                              compute_dtype="float32")
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    counters = ("residency_blocks", "hit_tokens", "transfers",
                "restored_tokens", "restore_events", "tier_moves",
                "store_residency")
    grouped = _grouped_requests(cfg.vocab)
    runs = {dev: _tiny_serve(cfg, params, dev, grouped, prefix_cache=True)
            for dev in ("cpu", "cuda")}
    tiers = {dev: r[2]["instances"]["e0"]["kv_tiers"]
             for dev, r in runs.items()}
    kv = {dev: {k: t[k] for k in counters} for dev, t in tiers.items()}
    check(runs["cuda"][:2] == runs["cpu"][:2] and kv["cuda"] == kv["cpu"]
          and kv["cuda"]["restore_events"] > 0
          and kv["cuda"]["hit_tokens"]["host"] > 0,
          f"tiny prefix-cached llama: the card differs from the CPU or "
          f"restored nothing through the host tier ({kv})")
    print(f"phase 4: tiny llama f32 with the prefix store, card == CPU: "
          f"tokens, decisions and KV-tier counters identical "
          f"({kv['cuda']['restore_events']} restores, "
          f"{kv['cuda']['restored_tokens']} tokens, host hits "
          f"{kv['cuda']['hit_tokens']['host']}, tier moves "
          f"{kv['cuda']['tier_moves']}, card tier_move_s "
          f"{tiers['cuda']['tier_move_s']:.4f})")
    reqs = generate(ShareGPTConfig(
        n_requests=5, rate=50.0, vocab=cfg.vocab, seed=3, mean_prompt=30,
        mean_output=8, sigma_prompt=0.4, sigma_output=0.3, max_prompt=60,
        max_output=10, share_fraction=0.0))
    for r in reqs:
        r.arrival = 0.0
    vanilla = _tiny_serve(cfg, params, "cpu", reqs)[0]
    unrelated = Model(cfg).init(torch.Generator().manual_seed(7))
    for label, draft_params in (("perfect", params),
                                ("unrelated", unrelated)):
        spec = SpecDecodeCfg(draft=cfg, k=3, draft_params=draft_params)
        runs = {dev: _tiny_serve(cfg, params, dev, reqs, spec=spec)
                for dev in ("cpu", "cuda")}
        sd = {dev: {k: v for k, v in r[2]["spec_decode"].items()
                    if k not in ("step_timeline", "instances_merged")}
              for dev, r in runs.items()}
        check(runs["cuda"][0] == runs["cpu"][0] == vanilla
              and runs["cuda"][1] == runs["cpu"][1]
              and sd["cuda"] == sd["cpu"],
              f"tiny spec decode ({label} draft): the tokens differ from "
              f"vanilla greedy, or the card from the CPU")
        print(f"phase 4: tiny llama f32 spec decode, {label} draft, k 3: "
              f"card == CPU == vanilla greedy tokens; "
              f"{sd['cuda']['steps']} steps, acceptance rate "
              f"{sd['cuda']['acceptance_rate']:.3f}")
    store_round_trip_on_card(torch)


def store_round_trip_on_card(torch):
    """A payload in the prefix store on the card: device -> host -> SSD ->
    device moves its bytes each step, the spill file goes away on the
    promotion, and the payload comes back bit for bit."""
    import os
    from repro_torch.serve import RealRadixCache
    gen = torch.Generator(device="cuda").manual_seed(5)
    data = {f"stage{i}": {n: torch.randn((2, 64, 8, 128), generator=gen,
                                         device="cuda").to(torch.bfloat16)
                          for n in ("k", "v")} for i in range(2)}
    nbytes = sum(t.nbytes for v in data.values() for t in v.values())
    store = RealRadixCache(device="cuda")
    toks = list(range(64))
    store.insert(toks, {**data, "_length": 60, "_length_bucket": 64})
    moved = [store.demote(toks, "host"), store.demote(toks, "ssd")]
    spill = store.store[tuple(toks)]["_ssd"]
    check(os.path.isfile(spill), "prefix store: no spill file on the SSD "
                                 "tier")
    moved.append(store.promote(toks))
    back = store.store[tuple(toks)]
    check(moved == [nbytes] * 3 and not os.path.exists(spill)
          and all(back[k][n].device.type == "cuda"
                  and torch.equal(back[k][n], data[k][n])
                  for k in data for n in ("k", "v")),
          f"prefix store round trip on the card: moved {moved} of "
          f"{nbytes} bytes, spill left: {os.path.exists(spill)}")
    print(f"phase 4: prefix store on the card: device -> host -> SSD -> "
          f"device moved {nbytes} bytes each step, the spill file removed, "
          f"the payload back bit for bit")


#: (arch, the kernels its serve must launch)
PATHS = (("llama3.1-8b", ("flash_attention", "paged_attention_decode",
                          "paged_attention_extend")),
         ("phimini-moe", ("flash_attention", "paged_attention_decode",
                          "paged_attention_extend", "moe_gmm")))


def serve_requests(vocab, n=8, seed=0, share=0.0):
    """The ShareGPT-shaped requests both full-width phases serve (8, seed
    0); ``tools/torch_fidelity.py`` serves more of the same shape.
    ``share``: the fraction that continue one of 4 conversations (the
    prefix-cache configuration's workload)."""
    from repro_torch.workload import ShareGPTConfig, generate
    return generate(ShareGPTConfig(
        n_requests=n, rate=10.0, vocab=vocab, seed=seed, mean_prompt=600,
        sigma_prompt=0.5, max_prompt=1024, mean_output=24, max_output=32,
        share_fraction=share, n_conversations=4 if share else 20))


def serve_scheduler():
    from repro_torch.core.config import SchedulerCfg
    return SchedulerCfg(chunked_prefill=True, prefill_chunk=256,
                        max_batch_size=8)


def full_serve_setup(torch, arch="llama3.1-8b"):
    """A full-width model on the card behind a warmed-up ServeDriver, and
    the 8 requests it serves: (cfg, engine, driver, requests)."""
    from repro_torch.configs import get_config
    from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine
    cfg = get_config(arch)
    check(cfg.n_layers == 32 and cfg.d_model == 4096, "not full width")
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, max_batch=8, max_len=2048, name="e0", seed=0)
    torch.cuda.synchronize()
    print(f"phase 4: {cfg.name} (32 layers, d_model 4096, bf16, seeded "
          f"random weights) made on the card in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    # one prefill must give finite logits of the padded-vocab shape
    logits, _ = eng.model.prefill(
        eng.params, torch.arange(64, device="cuda", dtype=torch.int32)[None],
        lengths=torch.tensor([64], dtype=torch.int32, device="cuda"))
    check(tuple(logits.shape) == (1, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"prefill logits {tuple(logits.shape)} not finite/of shape")
    reqs = serve_requests(cfg.vocab)
    drv = ServeDriver([eng], DriverCfg(scheduler=serve_scheduler()))
    drv.runtime.warmup()
    return cfg, eng, drv, reqs


def probe_tokens(reqs, n=128):
    """The first ``n`` prompt tokens of each of the serve's requests, the
    (B, n) prefill phase 6 holds tp = 2 to tp = 1 on."""
    import numpy as np
    return np.asarray([list(r.prompt_tokens[:n]) for r in reqs], np.int32)


def probe_logits(torch, eng, reqs):
    """bf16 prefill logits of ``probe_tokens`` (f32 copy on the host)."""
    toks = torch.from_numpy(probe_tokens(reqs)).to(eng.device)
    lengths = torch.full((toks.shape[0],), toks.shape[1], dtype=torch.int32,
                         device=eng.device)
    logits, _ = eng.model.prefill(eng.params, toks, lengths=lengths)
    return logits[:, 0].float().cpu().numpy()


def serve_full(torch, ops, card, arch, must_launch):
    """Serve phase 4's requests at full width: (the launch counts, the
    tp = 1 probe logits phase 6 compares with)."""
    cfg, eng, drv, reqs = full_serve_setup(torch, arch)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m = drv.run(reqs, warmup=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(m["finished"] == len(reqs),
          f"{arch}: finished {m['finished']} of {len(reqs)}")
    for name in must_launch:
        check(launches[name] > 0,
              f"{name} was not launched while serving {arch}")
    calls = (launches["flash_attention"] + launches["paged_attention_decode"]
             + launches["paged_attention_extend"]) // cfg.n_layers
    if "moe_gmm" in must_launch:
        # gate, up and down in each of the 32 MoE layers of every call
        check(launches["moe_gmm"] == 3 * cfg.n_layers * calls,
              f"{arch}: {launches['moe_gmm']} moe_gmm launches over "
              f"{calls} model calls, want {3 * cfg.n_layers} per call")
    backend = drv.runtime.instances["e0"].backend
    for r in drv.finished:
        toks = backend.out_tokens[r.req_id]
        check(len(toks) == r.output_len
              and all(0 <= t < cfg.vocab for t in toks),
              f"request {r.req_id}: {len(toks)} tokens of {r.output_len}")
    ttft = statistics.median(r.ttft() for r in drv.finished)
    tpot = statistics.median(r.tpot() for r in drv.finished
                             if r.tpot() is not None)
    n_out = sum(r.output_len for r in drv.finished)
    print(f"serve [{card}] {cfg.name} 8 requests (prompts "
          f"{min(r.prompt_len for r in drv.finished)}-"
          f"{max(r.prompt_len for r in drv.finished)}, chunk 256, batch 8): "
          f"TTFT p50 {ttft * 1e3:.1f} ms, TPOT p50 {tpot * 1e3:.2f} ms, "
          f"{n_out / wall:.1f} output tok/s over wall {wall:.2f} s, "
          f"{calls} model calls")
    print(f"launches while serving {cfg.name}: {json.dumps(launches)}")
    return launches, probe_logits(torch, eng, reqs)


#: the by-path key of the full-width speculative serve
SPEC_PATH = "spec llama3.1-8b"
SPEC_K = 4


def spec_serve_full(torch, ops, card):
    """llama3.1-8b at full width, bf16, speculating k = 4 with a draft that
    shares the target's weights, replaying ``synthesize_acceptance(alpha
    0.6, k 4)``, on phase 4's 8 requests all arriving at t = 0 (decode
    reserves k + 1 = 5 tokens a step).  Every request must finish, and the
    per-step accepted lengths (and decisions) must equal the port
    simulator's on the same trace.  Returns the serve's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.core import ClusterCfg, RouterCfg, SpecCfg
    from repro_torch.core.cluster import Cluster
    from repro_torch.models import Model
    from repro_torch.profiler import model_spec_from_arch
    from repro_torch.serve import (DriverCfg, ServeDriver, ServingEngine,
                                   SpecDecodeCfg)
    from repro_torch.serve.driver import engine_instance_cfg
    from repro_torch.spec import register_acceptance
    from repro_torch.workload.acceptance import (AcceptanceConfig,
                                                 synthesize_acceptance)
    cfg = get_config("llama3.1-8b")
    trace = synthesize_acceptance(AcceptanceConfig(alpha=0.6, k=SPEC_K),
                                  model=cfg.name)
    register_acceptance("chip-smoke-alpha0.6", trace)
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0),
                             device="cuda", dtype=torch.bfloat16)
    eng = ServingEngine(cfg, params, max_batch=8, max_len=2048, name="e0",
                        spec=SpecDecodeCfg(draft=cfg, k=SPEC_K,
                                           acceptance=trace,
                                           draft_params=params))
    check(eng.draft.params["embed"]["tok"].data_ptr()
          == eng.params["embed"]["tok"].data_ptr(),
          "spec serve: the draft does not share the target's weights")
    reqs = serve_requests(cfg.vocab)
    for r in reqs:
        r.arrival = 0.0
    sched = serve_scheduler()
    drv = ServeDriver([eng], DriverCfg(scheduler=sched))
    drv.runtime.warmup()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m = drv.run([dataclasses.replace(r) for r in reqs], warmup=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    inst = drv.runtime.instances["e0"]
    check(m["finished"] == len(reqs),
          f"spec serve: finished {m['finished']} of {len(reqs)}")
    for r in drv.finished:
        toks = inst.backend.out_tokens[r.req_id]
        check(len(toks) == r.output_len
              and all(0 <= t < cfg.vocab for t in toks),
              f"spec serve request {r.req_id}: {len(toks)} tokens of "
              f"{r.output_len}")
    verify_calls = sum(any(w[1] == "decode" for w in it)
                       for it in inst.decisions)
    check(verify_calls > 0
          and launches["paged_attention_extend"]
          >= verify_calls * cfg.n_layers
          and launches["paged_attention_decode"] > 0
          and launches["flash_attention"] > 0,
          f"spec serve: {verify_calls} verify calls, launches {launches}")
    sim = Cluster(ClusterCfg(instances=(engine_instance_cfg(
        eng, sched, spec=SpecCfg(enabled=True, k=SPEC_K,
                                 acceptance_trace="chip-smoke-alpha0.6",
                                 draft=model_spec_from_arch(cfg))),),
        router=RouterCfg("round_robin")))
    sim.submit_workload([dataclasses.replace(r) for r in reqs])
    sm = sim.run()
    real_sd = m["instances"]["e0"]["spec_decode"]
    sim_sd = sm["instances"]["e0"]["spec_decode"]
    steps = [(p, a) for _, p, a in real_sd["step_timeline"]]
    check(sm["finished"] == len(reqs)
          and steps == [(p, a) for _, p, a in sim_sd["step_timeline"]]
          and real_sd["accepted_hist"] == sim_sd["accepted_hist"]
          and list(inst.decisions) == list(sim.instances["e0"].decisions),
          "spec serve: the accepted lengths or decisions differ from the "
          "port simulator's on the same trace")
    tpot = statistics.median(r.tpot() for r in drv.finished
                             if r.tpot() is not None)
    n_out = sum(r.output_len for r in drv.finished)
    print(f"spec serve [{card}] llama3.1-8b bf16 k {SPEC_K}, draft sharing "
          f"the target's weights, acceptance replayed (alpha 0.6), 8 "
          f"requests at t = 0: TPOT p50 {tpot * 1e3:.2f} ms, "
          f"{n_out / wall:.1f} output tok/s over wall {wall:.2f} s; "
          f"{real_sd['steps']} spec steps, acceptance rate "
          f"{real_sd['acceptance_rate']:.3f}, mean accepted "
          f"{real_sd['mean_accepted_len']:.3f}; {verify_calls} verify calls "
          f"= {verify_calls * cfg.n_layers} paged extend launches at B8 "
          f"S<=5 (extend launches in all "
          f"{launches['paged_attention_extend']}); per-step accepted "
          f"lengths == simulator's ({len(steps)} steps); peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print(f"launches while serving with spec decoding: "
          f"{json.dumps(launches)}")
    return launches


# ---------------------------------------------------------------- phase 5
#: the profile grid covers phase 4's serve, so the simulator interpolates
#: and never extrapolates: whole prompts and chunks at buckets 16 to 1024,
#: decode contexts to 1280 (the serve's reach 1056) at batches 1, 4 and 8,
#: and 256-token extend chunks after 256, 512 and 768 tokens
PROFILE_GRID = ("--prefill-buckets", "16,32,64,128,256,512,1024",
                "--decode-ctxs", "64,128,256,512,768,1024,1280",
                "--extend-ctxs", "256,512,768", "--extend-suffixes", "256")
#: (configuration, arch) pairs of the Fig. 2 twin on the card
FIDELITY = (("S(D)", "llama3.1-8b"), ("M(D)", "llama3.1-8b"),
            ("PD(D)", "llama3.1-8b"), ("S(D)+PC", "llama3.1-8b"),
            ("S(M)", "phimini-moe"))


def profile_card(torch, ops, arch, reps=3):
    """``profile --device h100 --mode measured --kernels`` in process (the
    median of ``reps`` timings a point), the artifact reloaded through the
    port's registry: (its Trace, the run's launch counts)."""
    from repro_torch.hw import HardwareRegistry
    from repro_torch.profiler.__main__ import main as profiler_main
    out = ROOT / "build" / "traces" / f"h100-{arch}.json"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):   # the CLI's summary
        summary = profiler_main([
            "profile", "--device", "h100", "--mode", "measured", "--arch",
            arch, "--kernels", "--max-batch", "8", "--max-len", "2048",
            "--reps", str(reps), *PROFILE_GRID, "--out", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    hwt = HardwareRegistry().load_file(str(out))
    check(hwt.device == "h100" and hwt.model == arch
          and hwt.spec.name == "h100"
          and len(hwt.points) == summary["n_points"] > 0,
          f"profile {arch}: the reloaded artifact differs from the run")
    swept = hwt.meta["kernel_launches"]
    must = ["flash_attention", "paged_attention_decode"] + (
        ["moe_gmm"] if "moe" in arch else [])
    check(all(swept["cuda"][k] > 0 for k in must)
          and not any(swept["reference"].values()),
          f"profile {arch}: the cuda sweep launched {swept['cuda']}, the "
          f"reference sweep {swept['reference']}")
    probes = {k: n - swept["cuda"][k] for k, n in launches.items()}
    check(all(probes[k] > 0 for k in must + ["paged_attention_extend"]),
          f"profile {arch}: the runtime probes launched {probes}")
    kinds = {}
    for p in hwt.points:
        kinds[p.op] = kinds.get(p.op, 0) + 1
    print(f"phase 5: profiled {arch} on the card in {wall:.1f} s (runtime "
          f"probes {hwt.meta['profile_wall_s']:.1f} s, kernel sweep "
          f"{hwt.meta['kernel_wall_s']:.1f} s): {len(hwt.points)} points "
          f"{json.dumps(kinds)}; {out.relative_to(ROOT)} reloaded through "
          f"HardwareRegistry")
    print(f"  launches: kernel sweep {json.dumps(swept['cuda'])}; runtime "
          f"probes {json.dumps(probes)}")
    trace = hwt.to_trace()
    from repro_torch.bench.fig2_fidelity import kernel_attribution
    for r in kernel_attribution(trace, arch, "cuda"):
        if (r["phase"], r["tokens"], r["context"]) in (
                ("prefill", 256, 256), ("decode", 8, 512),
                ("decode", 8, 1024)):
            print(f"  {r['phase']} {r['tokens']}@{r['context']}: iteration "
                  f"{r['iter_ms']:.2f} ms, kern:cuda rows compose "
                  f"{r['kernel_sum_ms']:.2f} ms ({r['gap_pct']:+.1f}%; "
                  + ", ".join(f"{k} {100 * v:.0f}%"
                              for k, v in r["share"].items()) + ")")
    return trace, launches


def fidelity_card(torch, ops, card, traces, n=8, seed=0):
    """The Fig. 2 twin on the card on ``n`` requests from ``seed``: the
    launch counts of each configuration, and one row per configuration.
    At phase 5's 8 requests the run is a structural gate, too small to
    measure the error (``tools/torch_fidelity.py`` measures it)."""
    from repro_torch.bench.fig2_fidelity import PC_SHARE, compare, summarize
    from repro_torch.configs import get_config
    from repro_torch.serve import ServingEngine
    rows, by_config, params = [], {}, {}
    for config, arch in FIDELITY:
        cfg = get_config(arch)
        if arch not in params:
            params.clear()          # one full-width model on the card
            gc.collect()
            torch.cuda.empty_cache()
            params[arch] = ServingEngine(cfg, max_batch=1, max_len=64,
                                         seed=0).params
        pc = config.endswith("PC")
        reqs = serve_requests(cfg.vocab, n, seed,
                              share=PC_SHARE if pc else 0.0)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        row = compare(config, arch, reqs, traces[arch],
                      scheduler=serve_scheduler(), params=params[arch],
                      max_batch=8, max_len=2048)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        gc.collect()
        torch.cuda.empty_cache()
        must = ["flash_attention", "paged_attention_decode",
                "paged_attention_extend"] + (
            ["moe_gmm"] if "moe" in arch else [])
        check(all(launches[k] > 0 for k in must),
              f"fidelity {config}: launches {launches}")
        check(row["real_finished"] == row["sim_finished"] == len(reqs),
              f"fidelity {config}: finished real {row['real_finished']}, "
              f"sim {row['sim_finished']} of {len(reqs)}")
        if config.startswith("PD"):
            check(row["real_handoff_bytes"] > 0
                  and row["sim_handoff_bytes"] > 0,
                  f"fidelity {config}: the handoff moved "
                  f"{row['real_handoff_bytes']} / "
                  f"{row['sim_handoff_bytes']} bytes (real / sim)")
        attr = {side: (row[f"{side}_attr_requests"],
                       row[f"{side}_attr_max_gap_s"])
                for side in ("real", "sim")}
        check(all(n_req == len(reqs) and gap <= 1e-6
                  for n_req, gap in attr.values()),
              f"fidelity {config}: attribution (requests, largest gap of "
              f"a request's segments to its e2e latency) {attr}")
        if pc:
            kv = {side: row[f"{side}_kv_tiers"]["e0"]
                  for side in ("real", "sim")}
            check(all(kv[side]["restore_events"] > 0
                      for side in ("real", "sim")),
                  f"fidelity {config}: no prefix restored on one side {kv}")
        ratio = row["sim_tput"] / row["real_tput"]
        check(0.5 <= ratio <= 2.0,
              f"fidelity {config}: sim/real tokens/s {ratio:.3f} outside "
              f"[0.5, 2], a unit or pricing fault")
        print(f"fidelity [{card}] {config} {arch}, {n} requests, seed "
              f"{seed}: TTFT p50 real "
              f"{row['real_ttft_p50_ms']:.1f} sim {row['sim_ttft_p50_ms']:.1f}"
              f" ms ({row['ttft_err_pct']:.1f}%), TPOT mean real "
              f"{row['real_tpot_ms']:.2f} sim {row['sim_tpot_ms']:.2f} ms "
              f"({row['tpot_err_pct']:.1f}%), tokens/s real "
              f"{row['real_tput']:.1f} sim {row['sim_tput']:.1f} "
              f"({row['tput_err_pct']:.1f}%); handoff bytes real "
              f"{row['real_handoff_bytes']:.0f} sim "
              f"{row['sim_handoff_bytes']:.0f}")
        print("  iterations (count, mean ms) real / sim: " + ", ".join(
            f"{n} {row['real_iterations'][n]}, "
            f"{row['real_iter_ms'][n]:.2f} / {row['sim_iterations'][n]}, "
            f"{row['sim_iter_ms'][n]:.2f}" for n in row["real_iterations"]))
        if pc:
            print(f"  prefix store: restores real "
                  f"{kv['real']['restore_events']} "
                  f"({kv['real']['restored_tokens']} tokens) sim "
                  f"{kv['sim']['restore_events']} "
                  f"({kv['sim']['restored_tokens']} tokens); real "
                  f"tier_move_s {kv['real']['tier_move_s']:.4f}, residency "
                  f"{json.dumps(kv['real']['store_residency'])}; peak "
                  f"allocated {torch.cuda.max_memory_allocated() / 2**30:.1f}"
                  f" GiB")
        print("  attribution (segment totals, s) real / sim: "
              + ", ".join(f"{k} {row['real_segments'][k]:.3f} / "
                          f"{row['sim_segments'][k]:.3f}"
                          for k in row["real_segments"]))
        print(f"  launches: {json.dumps(launches)}")
        rows.append(row)
        by_config[f"fig2 {config} {arch}"] = launches
    params.clear()
    s = summarize(rows)
    print(f"fidelity [{card}], {n} requests, seed {seed}: TPOT and "
          f"tokens/s error mean {s['mean_err_pct']:.1f}%, max "
          f"{s['max_err_pct']:.1f}%; TTFT p50 error mean "
          f"{s['ttft_mean_err_pct']:.1f}%, max {s['ttft_max_err_pct']:.1f}%")
    return by_config, rows


def tiny_decisions_card_equal_sim(torch):
    """Tiny f32 llama, every arrival at 0: the real engine on the card and
    the port's simulator make the same decisions on every instance,
    unified (batch 2) and P/D (batch 1: the handoffs land at times the
    latencies set, and one at a time is decoded in the order the
    prefills ended)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ClusterCfg, RouterCfg
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.config import SchedulerCfg
    from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine
    from repro_torch.serve.driver import engine_instance_cfg
    from repro_torch.workload import ShareGPTConfig, generate
    cfg = dataclasses.replace(get_config("llama3.1-8b-tiny"),
                              compute_dtype="float32")

    def reqs():
        out = generate(ShareGPTConfig(
            n_requests=6, rate=50.0, vocab=cfg.vocab, seed=3,
            mean_prompt=60, mean_output=8, max_prompt=120, max_output=10,
            share_fraction=0.0))
        for r in out:
            r.arrival = 0.0
        return out
    for pd in (False, True):
        sched = SchedulerCfg(max_batch_size=1 if pd else 2,
                             max_batch_tokens=64, chunked_prefill=True,
                             prefill_chunk=32)
        first = ServingEngine(cfg, max_batch=2, max_len=256,
                              name="p0" if pd else "e0",
                              role="prefill" if pd else "unified")
        engines = [first] + ([ServingEngine(
            cfg, first.params, max_batch=2, max_len=256, name="d0",
            role="decode")] if pd else [])
        pd_map = {"p0": ("d0",)} if pd else None
        drv = ServeDriver(engines, DriverCfg(scheduler=sched),
                          pd_map=pd_map)
        real = drv.run(reqs(), warmup=False)
        sim = Cluster(ClusterCfg(
            instances=tuple(engine_instance_cfg(e, sched) for e in engines),
            router=RouterCfg("round_robin"), pd_map=pd_map))
        sim.submit_workload(reqs())
        m = sim.run()
        decisions = {n: i.decisions for n, i in drv.runtime.instances.items()}
        check(real["finished"] == m["finished"] == 6
              and decisions == {n: i.decisions
                                for n, i in sim.instances.items()},
              f"tiny {'P/D' if pd else 'unified'}: the card's decisions "
              f"differ from the simulator's")
        print(f"phase 5: tiny llama f32 {'P/D' if pd else 'unified'}, card "
              f"== simulator: "
              f"{sum(len(d) for d in decisions.values())} decisions "
              f"identical")


# ---------------------------------------------------------------- phase 6
def tenants_on_card(torch):
    """Two tenants (``repro_torch.workload.tenants``) served by tiny f32
    llama on the card under ``policy="priority"``, every arrival at 0: the
    decisions and the per-tenant rollup's counts and classes equal the
    port simulator's, and priority orders the queue (the twin of
    ``tests/test_tenants.py::test_tenant_parity_sim_vs_real_engine``)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ClusterCfg, RouterCfg, TenantClass
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.config import SchedulerCfg
    from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine
    from repro_torch.serve.driver import engine_instance_cfg
    from repro_torch.workload import (TenantSpec, TenantWorkloadCfg,
                                      generate_tenants)
    cfg = dataclasses.replace(get_config("llama3.1-8b-tiny"),
                              compute_dtype="float32")
    spec = dict(mean_prompt=40, max_prompt=90, mean_output=6, max_output=10)
    reqs = generate_tenants(TenantWorkloadCfg(tenants=(
        TenantSpec(TenantClass("gold", priority=10, slo_ttft_ms=500.0,
                               slo_tpot_ms=50.0, weight=3.0), **spec),
        TenantSpec(TenantClass("free", priority=0, slo_ttft_ms=5000.0,
                               slo_tpot_ms=500.0), **spec)),
        n_requests=8, rate=50.0, seed=7, vocab=cfg.vocab))
    for r in reqs:
        r.arrival = 0.0
    sched = SchedulerCfg(max_batch_size=2, max_batch_tokens=1 << 16,
                         policy="priority", chunked_prefill=False,
                         prefill_exclusive=True)
    eng = ServingEngine(cfg, max_batch=2, max_len=256, name="e0")
    drv = ServeDriver([eng], DriverCfg(scheduler=sched))
    real = drv.run([dataclasses.replace(r) for r in reqs], warmup=False)
    sim = Cluster(ClusterCfg(instances=(engine_instance_cfg(eng, sched),),
                             router=RouterCfg("round_robin")))
    sim.submit_workload([dataclasses.replace(r) for r in reqs])
    sm = sim.run()
    keys = ("submitted", "finished", "priority", "slo_ttft_ms",
            "slo_tpot_ms")
    roll = {side: {t: {k: row[k] for k in keys} for t, row in
                   m["tenants"].items()} for side, m in (("real", real),
                                                         ("sim", sm))}
    dec = list(drv.runtime.instances["e0"].decisions)
    order = []
    for it in dec:
        for rid, phase, _ in it:
            if phase == "prefill" and rid not in order:
                order.append(rid)
    prio = [reqs[rid].priority for rid in order[1:]]
    check(real["finished"] == sm["finished"] == len(reqs)
          and dec == list(sim.instances["e0"].decisions)
          and roll["real"] == roll["sim"] and sorted(roll["real"])
          == ["free", "gold"] and prio == sorted(prio, reverse=True),
          f"tenants on the card: decisions or rollup differ from the "
          f"simulator's ({roll}), or priority did not order the queue")
    print(f"phase 6: two tenants on the card under priority, tiny llama "
          f"f32: {len(dec)} decisions and the rollup "
          f"{json.dumps(roll['real'])} == the port simulator's")


TINY_ARCHS = ("llama3.1-8b-tiny", "phimini-moe-tiny")


def depth_cut_f32(cfg, layers=2):
    """``cfg`` at its published widths, f32, cut to ``layers`` layers."""
    return dataclasses.replace(
        cfg, compute_dtype="float32", n_layers=layers,
        stages=(dataclasses.replace(cfg.stages[0], n_layers=layers),))


def tiny_logits(torch, eng):
    """Prefill two slots (16 and 11 tokens, bucket 16), then two decode
    steps: the logits of each call, on the host."""
    import numpy as np
    rng = np.random.default_rng(5)
    out = []
    for slot, n in enumerate((16, 11)):
        pad = np.zeros((1, 16), np.int32)
        pad[0, :n] = rng.integers(0, eng.cfg.vocab, n)
        logits, c1 = eng.model.prefill(eng.params, eng.tensor(pad),
                                       lengths=eng.tensor([n]))
        eng._write_slot_from_prefill(slot, c1, n)
        out.append(logits.cpu().numpy())
    for _ in range(2):
        tok = rng.integers(0, eng.cfg.vocab, (2, 1)).astype(np.int32)
        for slot in range(2):
            eng.ensure_capacity(slot, int(eng.cache["lengths"][slot]) + 1)
        logits, eng.cache = eng.model.decode(eng.params, eng.cache,
                                             eng.tensor(tok))
        out.append(logits.cpu().numpy())
    return out


def _record_shapes(ops):
    """Wrap the three kernel entry points to note the head, KV-head and
    expert counts the model hands them (the wrappers still count their
    launches); returns (the set of shapes, the restore function)."""
    seen = set()
    flash, paged, gmm = ops.flash_attention, ops.paged_attention, ops.moe_gmm

    def rec_flash(q, k, *a, **kw):
        seen.add(("flash_attention", q.shape[-2], k.shape[-2]))
        return flash(q, k, *a, **kw)

    def rec_paged(q, kp, *a, **kw):
        seen.add(("paged_attention", q.shape[-2], kp.shape[-2]))
        return paged(q, kp, *a, **kw)

    def rec_gmm(x, w, *a, **kw):
        seen.add(("moe_gmm", x.shape[0]))
        return gmm(x, w, *a, **kw)

    def restore():
        ops.flash_attention, ops.paged_attention, ops.moe_gmm = \
            flash, paged, gmm
    ops.flash_attention, ops.paged_attention, ops.moe_gmm = \
        rec_flash, rec_paged, rec_gmm
    return seen, restore


#: phase 6's tiny f32 serving techniques at tp = 2 (``_tiny_technique``),
#: P/D also between engines of different tp
TINY_TECHNIQUES = ("pd", "prefix", "spec", "pd-2to1", "pd-1to2")
TINY_TRACE = "chip-smoke-tiny-alpha0.6"
#: the KV-tier counters held to tp = 1 (``tier_move_s`` is wall time)
KV_COUNTERS = ("residency_blocks", "hit_tokens", "restored_tokens",
               "restore_events", "tier_moves", "store_residency")


def _tiny_acceptance(cfg):
    from repro_torch.workload.acceptance import (AcceptanceConfig,
                                                 synthesize_acceptance)
    return synthesize_acceptance(
        AcceptanceConfig(alpha=0.6, k=3, period=64, seed=5), model=cfg.name)


def _three_tiers(instances):
    """Three device blocks and one host block, spilling on to the SSD, so
    the shared-prefix workload's entries walk device -> host -> SSD ->
    device; counted in blocks, so tp = 1 and tp = 2 walk alike."""
    for inst in instances:
        inst.cache.capacity_blocks = 3
        inst.cache.cfg = dataclasses.replace(inst.cache.cfg, ssd_spill=True)
        inst.mem.host.capacity = inst.mem.bytes_per_block


def _tiny_technique(cfg, params, draft, dev, technique, group=None):
    """Tiny f32 llama serving one technique on ``dev`` (``group``: the
    rank's engine group, or None for tp = 1): "pd", a prefill and a
    decode engine sharing the weights, at batches of one (the decisions
    then do not depend on when the handoffs land), at the tp of
    ``PD_TP`` on the ranks; "prefix", the prefix store on the two-phase
    shared-prefix workload through ``_three_tiers``; "spec", k = 3 with
    an unrelated draft (``draft``: its params) replaying one acceptance
    trace.  Every arrival at 0 (the prefix workload's phases far apart).
    Returns what phase 6 holds tp = 2 to tp = 1 and the simulator on."""
    from repro_torch.core.config import SchedulerCfg
    from repro_torch.serve import (DriverCfg, ServeDriver, ServingEngine,
                                   SpecDecodeCfg)
    kw = dict(max_batch=2, max_len=256, device=dev)
    sched = dict(max_batch_size=2, max_batch_tokens=64,
                 chunked_prefill=True, prefill_chunk=16)
    reqs, pd_map = _tiny_requests(cfg.vocab), None
    if technique in PD_TP:
        ptp, dtp = PD_TP[technique]
        engines = [ServingEngine(cfg, params, name="p0", role="prefill",
                                 **kw, **ranks_kw(group, ptp)),
                   ServingEngine(cfg, params, name="d0", role="decode",
                                 **kw, **ranks_kw(group, dtp))]
        pd_map, sched["max_batch_size"] = {"p0": ("d0",)}, 1
    elif technique == "prefix":
        engines = [ServingEngine(cfg, params, name="e0", prefix_cache=True,
                                 **kw, **ranks_kw(group, TP))]
        reqs = _grouped_requests(cfg.vocab)
    else:
        engines = [ServingEngine(cfg, params, name="e0", **kw,
                                 **ranks_kw(group, TP),
                                 spec=SpecDecodeCfg(
                                     draft=cfg, k=3, draft_params=draft,
                                     acceptance=_tiny_acceptance(cfg)))]
    drv = ServeDriver(engines, DriverCfg(scheduler=SchedulerCfg(**sched)),
                      pd_map=pd_map)
    if technique == "prefix":
        _three_tiers(drv.runtime.instances.values())
    m = drv.run([dataclasses.replace(r) for r in reqs], warmup=False)
    check(m["finished"] == len(reqs),
          f"tiny {technique} on {dev}: finished {m['finished']} of "
          f"{len(reqs)}")
    insts = drv.runtime.instances
    stats = m["instances"]
    return dict(
        tokens={n: dict(i.backend.out_tokens) for n, i in insts.items()},
        decisions={n: list(i.decisions) for n, i in insts.items()},
        icfgs=[i.cfg for i in insts.values()], pd_map=pd_map,
        network_bytes=m.get("network_bytes"),
        kv_tiers={n: s["kv_tiers"] for n, s in stats.items()
                  if "kv_tiers" in s},
        spec_decode={n: s["spec_decode"] for n, s in stats.items()
                     if "spec_decode" in s},
        ssd_dir=engines[0].radix._ssd_dir if technique == "prefix"
        else None)


def _tiny_technique_sim(cfg, technique, row):
    """The port simulator at the row's tp on the same workload: its
    decisions by instance (spec replays the same acceptance trace)."""
    from repro_torch.core import SpecCfg
    from repro_torch.profiler import model_spec_from_arch
    from repro_torch.spec import register_acceptance
    icfgs = row["icfgs"]
    if technique == "spec":
        register_acceptance(TINY_TRACE, _tiny_acceptance(cfg))
        icfgs = [dataclasses.replace(i, spec=SpecCfg(
            enabled=True, k=3, acceptance_trace=TINY_TRACE,
            draft=model_spec_from_arch(cfg))) for i in icfgs]
    reqs = _grouped_requests(cfg.vocab) if technique == "prefix" \
        else _tiny_requests(cfg.vocab)
    return _sim_decisions(icfgs, reqs, row["pd_map"],
                          tiers=technique == "prefix")[1]


def _full_tp_serve(torch, ops, group, arch, technique):
    """One rank of a full-width bf16 tp = 2 serve of phase 4's 8 requests:
    "unified" (each rank draws the seeded weights and keeps its shard),
    "pd" (a prefill and a decode engine, each drawing the seeded weights
    and keeping its shard: two shards a rank), "spec" (k = 4, a draft
    sharing the target's weights, acceptance replayed at alpha 0.6, every
    arrival at 0; the draft is a tp = 1 engine holding the full weights
    on the rank, the target's shard cut from them), or "pd-2to1" /
    "pd-1to2" (P/D between a tp = 2 engine and a tp = 1 engine replicated
    on both ranks: the rank draws the seeded weights once, the replica
    holds them and the shard is cut from them)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import (DriverCfg, ServeDriver, ServingEngine,
                                   SpecDecodeCfg)
    from repro_torch.workload.acceptance import (AcceptanceConfig,
                                                 synthesize_acceptance)
    import torch.distributed as dist
    cfg = get_config(arch)
    reqs = serve_requests(cfg.vocab)
    kw = dict(max_batch=8, max_len=2048, seed=0, tp=group.size, group=group)
    pd_map = {"p0": ("d0",)} if technique in PD_TP else None
    if technique == "spec":
        for r in reqs:
            r.arrival = 0.0

    def build():
        if technique == "pd":
            return [ServingEngine(cfg, name="p0", role="prefill", **kw),
                    ServingEngine(cfg, name="d0", role="decode", **kw)]
        if technique == "unified":
            return [ServingEngine(cfg, name="e0", **kw)]
        params = Model(cfg).init(
            torch.Generator(device=group.device).manual_seed(0),
            device=group.device, dtype=torch.bfloat16)
        if technique in PD_TP:
            return [ServingEngine(cfg, params, name=name, role=role,
                                  max_batch=8, max_len=2048,
                                  **ranks_kw(group, tp))
                    for name, role, tp in zip(("p0", "d0"),
                                              ("prefill", "decode"),
                                              PD_TP[technique])]
        trace = synthesize_acceptance(AcceptanceConfig(alpha=0.6, k=SPEC_K),
                                      model=cfg.name)
        return [ServingEngine(cfg, params, name="e0", **kw,
                              spec=SpecDecodeCfg(draft=cfg, k=SPEC_K,
                                                 acceptance=trace,
                                                 draft_params=params))]

    # the ranks build in turn: a seeded draw of the full weights (its f32
    # temporaries included) holds about twice a shard until the engine
    # frees it, too much for both ranks at once on one card
    for turn in range(group.size):
        if turn == group.rank:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            engines = build()
            torch.cuda.empty_cache()    # the draw's temporaries
            torch.cuda.synchronize()
            row = {"made_s": time.perf_counter() - t0,
                   "init_peak_gib": torch.cuda.max_memory_allocated()
                   / 2**30,
                   "resident_gib": torch.cuda.memory_allocated() / 2**30}
        dist.barrier()
    if technique == "unified":
        row["probe"] = probe_logits(torch, engines[0], reqs)
    elif technique in PD_TP and technique != "pd":
        # the tp = 2 engine's prefill, and the replica's (tp = 1's draw)
        row["probe"], row["replica_probe"] = (
            probe_logits(torch, e, reqs)
            for e in sorted(engines, key=lambda e: -e.tp))
    drv = ServeDriver(engines, DriverCfg(scheduler=serve_scheduler()),
                      pd_map=pd_map)
    drv.runtime.warmup()
    torch.cuda.reset_peak_memory_stats()
    seen, restore = _record_shapes(ops)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        m = drv.run(reqs, warmup=False)
        torch.cuda.synchronize()
    finally:
        restore()
    row["wall_s"] = time.perf_counter() - t0
    row["launches"] = ops.launch_counts()
    row["shapes"] = sorted(seen)
    row["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    insts = drv.runtime.instances
    out = {rid: toks for i in insts.values()
           for rid, toks in i.backend.out_tokens.items()}
    row["finished"] = m["finished"]
    row["prompt_lens"] = [r.prompt_len for r in drv.finished]
    row["tokens_ok"] = all(
        len(out[r.req_id]) == r.output_len
        and all(0 <= t < cfg.vocab for t in out[r.req_id])
        for r in drv.finished)
    row["tokens"] = out
    row["decisions"] = {n: list(i.decisions) for n, i in insts.items()}
    row["icfgs"] = [i.cfg for i in insts.values()]
    row["network_bytes"] = m.get("network_bytes")
    row["spec_decode"] = m["instances"][engines[0].name].get("spec_decode")
    row["ttft_p50_ms"] = statistics.median(r.ttft() for r in drv.finished) \
        * 1e3
    row["tpot_p50_ms"] = statistics.median(
        r.tpot() for r in drv.finished if r.tpot() is not None) * 1e3
    row["n_out"] = sum(r.output_len for r in drv.finished)
    del engines, drv, insts, m
    gc.collect()                # ServeDriver and its runtime form a cycle
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < 2**30,
          f"rank {group.rank}: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB still allocated after the {technique} {arch} serve")
    return row


#: phase 6's full-width tp = 2 serves: (by-path key, arch, technique)
FULL_TP = ((TP2_PATH, "llama3.1-8b", "unified"),
           (TP2_MOE_PATH, "phimini-moe", "unified"),
           (TP2_PD_PATH, "llama3.1-8b", "pd"),
           (TP2_SPEC_PATH, "llama3.1-8b", "spec"),
           (TP2_PD21_PATH, "llama3.1-8b", "pd-2to1"),
           (TP2_PD12_PATH, "llama3.1-8b", "pd-1to2"))


def _tp2_rank(group, job):
    """One of phase 6's two ranks on the card: the tiny f32 serves and
    logits, the tiny serving techniques, then the full-width bf16
    serves."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serve import ServingEngine
    out = {"backend": group.backend, "device": str(group.device),
           "tiny": {}, "tech": {}, "full": {}}
    for arch, params in job["tiny"]:
        cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
        ops.reset_launch_counts()
        toks, dec, m, icfg = _tiny_serve(
            cfg, params, group.device, _tiny_requests(cfg.vocab),
            max_batch=4, chunk=32, tp=group.size, group=group)
        launches = ops.launch_counts()
        eng = ServingEngine(cfg, params, max_batch=2, max_len=128,
                            tp=group.size, group=group)
        out["tiny"][arch] = dict(tokens=toks, decisions=dec, icfg=icfg,
                                 launches=launches,
                                 logits=tiny_logits(torch, eng))
    cfg = dataclasses.replace(get_config(TINY_ARCHS[0]),
                              compute_dtype="float32")
    for technique in TINY_TECHNIQUES:
        ops.reset_launch_counts()
        row = _tiny_technique(cfg, job["tiny"][0][1], job["draft"],
                              group.device, technique, group=group)
        row["launches"] = ops.launch_counts()
        out["tech"][technique] = row
    out["cut"] = {}
    for arch in job["cut"]:
        eng = ServingEngine(depth_cut_f32(get_config(arch)), max_batch=2,
                            max_len=128, seed=0, tp=group.size, group=group)
        out["cut"][arch] = tiny_logits(torch, eng)
        del eng
        torch.cuda.empty_cache()
    for path, arch, technique in FULL_TP:
        out["full"][path] = _full_tp_serve(torch, ops, group, arch,
                                           technique)
    return out


def _tiny_techniques_check(ranks, refs, cfg, by_path):
    """Phase 6 (b'): each tiny technique on the ranks against tp = 1 on
    the card and the port simulator at the engines' tp (a P/D pair of
    different tp: tp 2 -> 1 and 1 -> 2, the tp = 1 engine replicated)."""
    must = ("flash_attention", "paged_attention_decode",
            "paged_attention_extend")
    for technique in TINY_TECHNIQUES:
        r0, r1 = (r["tech"][technique] for r in ranks)
        ref = refs[technique]
        sim = _tiny_technique_sim(cfg, technique, r0)
        tps = dict(zip(("p0", "d0"), PD_TP.get(technique, (TP, TP))))
        check(r0["tokens"] == r1["tokens"] == ref["tokens"]
              and r0["decisions"] == r1["decisions"] == ref["decisions"]
              == sim
              and all(r0["launches"][k] > 0 for k in must)
              and all(i.parallelism.tp == tps.get(i.name, TP)
                      for i in r0["icfgs"]),
              f"tiny {technique} on the ranks on the card: tokens, decisions "
              f"(== tp = 1 {r0['decisions'] == ref['decisions']}, == sim "
              f"{r0['decisions'] == sim}) or launches {r0['launches']} "
              f"differ")
        what = ""
        if technique in PD_TP:
            nb = (r0["network_bytes"], r1["network_bytes"],
                  ref["network_bytes"])
            check(nb[0] == nb[1] == nb[2] and nb[2]["d0<->p0"] > 0,
                  f"tiny {technique}: handoff bytes {nb} (ranks, tp = 1)")
            what = f"handoff bytes {nb[0]['d0<->p0']:.0f} == tp = 1's"
        elif technique == "prefix":
            kv = [r["kv_tiers"]["e0"] for r in (r0, r1, ref)]
            blocks = [{p: t["blocks"] for p, t in k["transfers"].items()}
                      for k in kv]
            half = [{p: t["bytes"] * (2 if i < 2 else 1)
                     for p, t in k["transfers"].items()}
                    for i, k in enumerate(kv)]
            check(all(kv[0][c] == kv[1][c] == kv[2][c] for c in KV_COUNTERS)
                  and blocks[0] == blocks[1] == blocks[2]
                  and half[0] == half[1] == half[2]
                  and {"device->host", "host->ssd", "ssd->device"}
                  <= set(blocks[0]) and kv[0]["restore_events"] > 0
                  and kv[0]["tier_move_s"] == kv[1]["tier_move_s"]
                  and r0["ssd_dir"] and r1["ssd_dir"]
                  and r0["ssd_dir"] != r1["ssd_dir"],
                  f"tiny prefix store at tp = 2: KV-tier counters "
                  f"{[{c: k[c] for c in KV_COUNTERS} for k in kv]}, "
                  f"transfers {blocks}, spill dirs "
                  f"{r0['ssd_dir']} / {r1['ssd_dir']}")
            what = (f"KV-tier counters == tp = 1's, transfers {blocks[0]} "
                    f"(a rank's half of tp = 1's bytes), "
                    f"{kv[0]['restored_tokens']} tokens restored, a spill "
                    f"directory a rank")
        else:
            sd = [{k: (v if k != "step_timeline" else
                       [e[1:] for e in v])
                   for k, v in r["spec_decode"]["e0"].items()}
                  for r in (r0, r1, ref)]
            check(sd[0] == sd[1] == sd[2] and sd[0]["steps"] > 0,
                  f"tiny spec at tp = 2: spec_decode differs from tp = 1")
            what = (f"spec_decode == tp = 1's ({sd[0]['steps']} steps, "
                    f"acceptance rate {sd[0]['acceptance_rate']:.3f})")
        by_path[f"tp2 {technique} {TINY_ARCHS[0]}"] = r0["launches"]
        at = f"tp {tps['p0']} -> {tps['d0']}" \
            if tps["p0"] != tps["d0"] else f"tp = {TP}"
        print(f"phase 6: tiny llama f32 {technique} at {at} (two ranks on "
              f"the card): tokens and decisions == tp = 1 on the card == the "
              f"simulator's at {at} on both ranks; {what}; launches "
              f"{json.dumps(r0['launches'])}")


def _sim_decisions(icfgs, reqs, pd_map=None, tiers=False):
    """The port simulator at the InstanceCfgs' tp (2, or 1 for the tp = 1
    engine of a P/D pair of different tp) on ``reqs``, its prefix caches
    held to ``_three_tiers`` when ``tiers``: (its metrics, its decisions
    by instance)."""
    from repro_torch.core import ClusterCfg, RouterCfg
    from repro_torch.core.cluster import Cluster
    check(TP in {i.parallelism.tp for i in icfgs} <= {1, TP},
          f"sim twin at tp {[i.parallelism.tp for i in icfgs]}")
    sim = Cluster(ClusterCfg(instances=tuple(icfgs),
                             router=RouterCfg("round_robin"),
                             pd_map=pd_map))
    if tiers:
        _three_tiers(sim.instances.values())
    sim.submit_workload([dataclasses.replace(r) for r in reqs])
    sm = sim.run()
    check(sm["finished"] == len(reqs), "sim twin: unfinished")
    return sm, {n: list(i.decisions) for n, i in sim.instances.items()}


def _full_tp_check(card, path, arch, technique, r0, r1, probes):
    """Phase 6 (c): one full-width tp = 2 serve's two rank rows.  Every
    request finishes with tokens in the vocab, both ranks decide alike,
    the kernels launch at the rank's shapes (and, speculating, the tp = 1
    draft's; a P/D pair of different tp: the prefill side's and the
    decode side's, the replica at every head); unified: the prefill argmax
    agreement with tp = 1; P/D: the handoff bytes equal tp = 1's payloads
    (across tp also: both ranks emit the same tokens, and the argmax
    agreement of the tp = 2 engine's prefill and the replica's with tp =
    1); spec: the per-step accepted lengths equal the simulator's at tp =
    2.  Prints each rank's memory and times, two ranks sharing one card
    (not a TP speed)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import SpecCfg
    from repro_torch.profiler import model_spec_from_arch
    from repro_torch.serve.engine import _bucket
    from repro_torch.spec import register_acceptance
    from repro_torch.workload.acceptance import (AcceptanceConfig,
                                                 synthesize_acceptance)
    cfg = get_config(arch)
    H, KV = cfg.n_heads // TP, cfg.n_kv_heads // TP

    def heads(tp):
        return cfg.n_heads // tp, cfg.n_kv_heads // tp
    ptp, dtp = PD_TP.get(technique, (TP, TP))
    want = {("flash_attention", *heads(ptp)), ("paged_attention", *heads(ptp)),
            ("paged_attention", *heads(dtp))}
    if cfg.moe is not None:
        want.add(("moe_gmm", cfg.moe.n_experts // TP))
    if technique == "spec":         # the tp = 1 draft: every head
        want |= {("flash_attention", cfg.n_heads, cfg.n_kv_heads),
                 ("paged_attention", cfg.n_heads, cfg.n_kv_heads)}
    reqs = serve_requests(cfg.vocab)
    n_dec = sum(len(d) for d in r0["decisions"].values())
    check(r0["finished"] == r1["finished"] == len(reqs)
          and r0["tokens_ok"] and r1["tokens_ok"]
          and r0["decisions"] == r1["decisions"]
          and set(r0["shapes"]) == set(r1["shapes"]) == want,
          f"{path} at tp = 2: finished {r0['finished']}/{r1['finished']}, "
          f"decisions equal {r0['decisions'] == r1['decisions']}, shapes "
          f"{r0['shapes']} (want {sorted(want)})")
    def agreement(key):
        check(all(np.isfinite(r[key]).all() for r in (r0, r1)),
              f"{path}: probe logits not finite")
        ref = probes[arch]
        agree = int((r0[key].argmax(-1) == ref.argmax(-1)).sum())
        diff = float(np.abs(r0[key] - ref).max())
        return (f"agrees with tp = 1 on {agree} of {ref.shape[0]} prompts "
                f"(128 tokens, max |logit diff| {diff:.3g})")
    what = ""
    if technique == "unified":
        what = f"prefill argmax {agreement('probe')}"
    elif technique in PD_TP and technique != "pd":
        check(r0["tokens"] == r1["tokens"],
              f"{path}: the ranks emitted different tokens")
        what = (f"both ranks emit the same tokens; the tp = 2 engine's "
                f"prefill argmax {agreement('probe')}, the replica's "
                f"{agreement('replica_probe')}; ")
    if technique in PD_TP:
        # the group's bytes: tp = 1's bucketed payload of each prompt
        per_row = 2 * sum(st.n_layers for st in cfg.stages) \
            * cfg.n_kv_heads * cfg.d_head * 2
        want_b = sum(per_row * _bucket(n) for n in r0["prompt_lens"])
        nb = (r0["network_bytes"], r1["network_bytes"])
        check(nb[0] == nb[1] and nb[0]["d0<->p0"] == want_b,
              f"{path}: handoff bytes {nb}, want {want_b} (tp = 1's "
              f"payloads)")
        what += (f"{nb[0]['d0<->p0']:.0f} handoff bytes on both ranks == "
                 f"tp = 1's payloads")
    elif technique == "spec":
        name = f"chip-smoke-tp2-{cfg.name}"
        register_acceptance(name, synthesize_acceptance(
            AcceptanceConfig(alpha=0.6, k=SPEC_K), model=cfg.name))
        icfgs = [dataclasses.replace(i, spec=SpecCfg(
            enabled=True, k=SPEC_K, acceptance_trace=name,
            draft=model_spec_from_arch(cfg))) for i in r0["icfgs"]]
        sm, sdec = _sim_decisions(icfgs, [dataclasses.replace(
            r, arrival=0.0) for r in reqs])
        sd = (r0["spec_decode"], r1["spec_decode"],
              sm["instances"]["e0"]["spec_decode"])
        steps = [[(p, a) for _, p, a in s["step_timeline"]] for s in sd]
        verify_calls = sum(any(w[1] == "decode" for w in it)
                           for it in r0["decisions"]["e0"])
        layers = sum(st.n_layers for st in cfg.stages)
        check(steps[0] == steps[1] == steps[2] and len(steps[0]) > 0
              and sd[0]["accepted_hist"] == sd[2]["accepted_hist"]
              and r0["decisions"] == sdec
              and r0["launches"]["paged_attention_extend"]
              >= verify_calls * layers > 0,
              f"{path}: the ranks' accepted lengths or decisions differ "
              f"from each other or the simulator's at tp = 2, or fewer "
              f"extend launches than {verify_calls} verify calls need")
        what = (f"per-step accepted lengths == the simulator's at tp = 2 "
                f"({len(steps[0])} steps, mean accepted "
                f"{sd[0]['mean_accepted_len']:.3f}); {verify_calls} verify "
                f"calls = {verify_calls * layers} paged extend "
                f"launches at B8 S<=5 H{H} KV{KV}")
    replicated = ", the tp = 1 engine replicated on both" \
        if ptp != dtp else ""
    print(f"phase 6 [{card}] {path} bf16, two ranks sharing one card "
          f"(gloo{replicated}), 8 requests: all finished, {n_dec} "
          f"decisions equal on both ranks; kernels launched at "
          f"{r0['shapes']}; {what}; per "
          f"rank: resident {r0['resident_gib']:.2f} / "
          f"{r1['resident_gib']:.2f} GiB, peak while making the engines "
          f"{r0['init_peak_gib']:.2f} / {r1['init_peak_gib']:.2f} GiB, peak "
          f"while serving {r0['serve_peak_gib']:.2f} / "
          f"{r1['serve_peak_gib']:.2f} GiB")
    print(f"  two ranks sharing one card, not a TP speed: TTFT p50 "
          f"{r0['ttft_p50_ms']:.1f} / {r1['ttft_p50_ms']:.1f} ms, TPOT p50 "
          f"{r0['tpot_p50_ms']:.2f} / {r1['tpot_p50_ms']:.2f} ms, "
          f"{r0['n_out'] / r0['wall_s']:.1f} / "
          f"{r1['n_out'] / r1['wall_s']:.1f} output tok/s over wall "
          f"{r0['wall_s']:.2f} / {r1['wall_s']:.2f} s (rank 0 / 1); engines "
          f"made in {r0['made_s']:.1f} s; launches "
          f"{json.dumps(r0['launches'])}")


def tp2_on_card(torch, card, probes):
    """Phase 6 (b) and (c): two ranks of one engine group share the card
    over gloo (the collectives stage CUDA tensors through the host).  A
    correctness check of the sharded path: no time here is a TP speed.
    (b) tiny f32 llama and phimini-moe (expert parallel, E4 -> E2 a rank):
    tokens == tp = 1 on the card == the CPU's, decisions equal on both
    ranks and == the port simulator's at tp = 2, prefill and decode logits
    within 1e-5 of tp = 1; then tiny f32 llama under P/D, with the prefix
    store walking device -> host -> SSD -> device, speculating, and
    under P/D between engines of different tp (2 -> 1 and 1 -> 2, the tp
    = 1 engine replicated on both ranks): tokens, decisions, handoff
    bytes, KV-tier counters and ``spec_decode`` == tp = 1 on the card,
    decisions == the simulator's at the engines' tp.  (c) full-width
    bf16 llama3.1-8b and phimini-moe (E16 -> E8) serving phase 4's 8
    requests, and llama3.1-8b under P/D (two shards a rank), speculating
    at k = 4 (a tp = 1 draft a rank, its accepted lengths == the
    simulator's at tp = 2), and under P/D 2 -> 1 and 1 -> 2 (a replica
    and a shard a rank, from one draw; the handoffs carry tp = 1's
    bytes, both ranks emit the same tokens): every request finishes,
    both ranks decide alike, the kernels launch at the rank's shapes (16
    query, 4 KV heads; 8 experts; the draft and a replica at the full 32
    and 8), and the prefill argmax agreement with tp = 1 is printed.  Between
    them, both models at published width in f32 cut to 2 layers: logits
    within 1e-4 of tp = 1.  Returns the launch counts of each tp = 2 path
    (rank 0's)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import Model
    from repro_torch.serve import ServingEngine
    tiny, refs = [], {}
    for arch in TINY_ARCHS:
        cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
        params = Model(cfg).init(torch.Generator().manual_seed(0))
        tiny.append((arch, params))
        refs[arch] = dict(
            card=_tiny_run(torch, arch, params, "cuda")[:2],
            cpu=_tiny_run(torch, arch, params, "cpu")[:2],
            logits=tiny_logits(torch, ServingEngine(
                cfg, params, max_batch=2, max_len=128, device="cuda")))
    llama = dataclasses.replace(get_config(TINY_ARCHS[0]),
                                compute_dtype="float32")
    draft = Model(llama).init(torch.Generator().manual_seed(7))
    # tp = 1 on the card; a P/D pair of different tp is the P/D serve there
    tech_refs = {t: _tiny_technique(llama, tiny[0][1], draft, "cuda", t)
                 for t in TINY_TECHNIQUES if t not in ("pd-2to1", "pd-1to2")}
    tech_refs["pd-2to1"] = tech_refs["pd-1to2"] = tech_refs["pd"]
    cut_archs = [arch for _, arch, t in FULL_TP if t == "unified"]
    cut = {}
    for arch in cut_archs:
        cut[arch] = tiny_logits(torch, ServingEngine(
            depth_cut_f32(get_config(arch)), max_batch=2, max_len=128,
            seed=0))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(_tp2_rank, TP, {"tiny": tiny, "draft": draft,
                                      "cut": cut_archs},
                      device="cuda", devices=["cuda:0"] * TP,
                      timeout_s=600)
    wall = time.perf_counter() - t0
    check(all(r["backend"] == "gloo" and r["device"] == "cuda:0"
              for r in ranks),
          f"tp = 2 ranks: {[(r['backend'], r['device']) for r in ranks]}")
    by_path = {}
    for arch in TINY_ARCHS:
        r0, r1 = (r["tiny"][arch] for r in ranks)
        ref = refs[arch]
        vocab = get_config(arch).vocab
        err = max(float(np.abs(g - w).max()) for r in (r0, r1)
                  for g, w in zip(r["logits"], ref["logits"]))
        close = all(np.allclose(g, w, rtol=1e-5, atol=1e-5)
                    for r in (r0, r1)
                    for g, w in zip(r["logits"], ref["logits"]))
        must = ["flash_attention", "paged_attention_decode",
                "paged_attention_extend"] + (["moe_gmm"] if "moe" in arch
                                             else [])
        check(r0["tokens"] == r1["tokens"] == ref["card"][0]
              == ref["cpu"][0]
              and r0["decisions"] == r1["decisions"] == ref["card"][1]
              == _sim_decisions([r0["icfg"]],
                                _tiny_requests(vocab))[1]["e0"]
              and close and all(r0["launches"][k] > 0 for k in must),
              f"tiny {arch} at tp = 2 on the card: tokens, decisions, "
              f"logits (max err {err:.3g}) or launches "
              f"{r0['launches']} differ from tp = 1")
        by_path[f"tp2 {arch}"] = r0["launches"]
        print(f"phase 6: tiny {arch} f32 at tp = 2 (two ranks on the card, "
              f"gloo): tokens == tp = 1 on the card == the CPU's, "
              f"{len(r0['decisions'])} decisions equal on both ranks and "
              f"== the simulator's at tp = 2, logits max err {err:.3g} "
              f"(tol 1e-5); launches {json.dumps(r0['launches'])}")
    _tiny_techniques_check(ranks, tech_refs, llama, by_path)
    for arch in cut_archs:
        # published widths, f32, two layers: the sharded path itself
        # (expert parallel E16 -> E8 for phimini-moe) against tp = 1, with
        # no bf16 rounding for the ranks' other summation order to move
        err = max(float(np.abs(g - w).max()) for r in ranks
                  for g, w in zip(r["cut"][arch], cut[arch]))
        check(all(np.allclose(g, w, rtol=TOL["float32"],
                              atol=TOL["float32"])
                  for r in ranks for g, w in zip(r["cut"][arch], cut[arch])),
              f"{arch} f32 cut to 2 layers at tp = 2: logits max err "
              f"{err:.3g} against tp = 1")
        print(f"phase 6: {arch} at published widths, f32, 2 layers, tp = 2 "
              f"on the card: prefill and decode logits max err {err:.3g} "
              f"against tp = 1 (tol {TOL['float32']})")
    for path, arch, technique in FULL_TP:
        r0, r1 = (r["full"][path] for r in ranks)
        by_path[path] = r0["launches"]
        _full_tp_check(card, path, arch, technique, r0, r1, probes)
    print(f"phase 6: the two ranks ran {wall:.1f} s (spawn included)")
    return by_path


# ---------------------------------------------------------------- phase 7
ZAMBA_PATH = "zamba2-1.2b"
XLSTM_PATH = "xlstm-125m"
#: what zamba2-1.2b's shared attention hands the kernels: (kernel, query
#: heads, KV heads), at head dim 64
ZAMBA_SHAPES = {("flash_attention", 32, 32), ("paged_attention", 32, 32)}


def recurrent_requests(vocab, lo, hi, out=64, n=8, seed=0, rate=10.0):
    """``n`` requests with prompts of ``lo``..``hi`` tokens and ``out``
    output tokens each, Poisson arrivals at ``rate`` a second (all at 0
    when ``rate`` is None)."""
    import numpy as np
    from repro_torch.workload.sharegpt import Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    gaps = rng.exponential(1.0 / (rate or 1.0), n)
    t = np.concatenate([[0.0], np.cumsum(gaps[1:])]) if rate else \
        np.zeros(n)
    return [Request(req_id=i, arrival=float(t[i]),
                    prompt_tokens=rng.integers(0, vocab, int(lens[i]))
                    .tolist(), output_len=out) for i in range(n)]


def recurrent_serve_setup(torch, arch):
    """A full-width recurrent model on the card behind a warmed-up
    ServeDriver, and the 8 requests it serves: (cfg, engine, driver,
    requests).  zamba2-1.2b: 38 layers, d_model 2048, max_len 2048,
    chunked prefill of 256, prompts of 128-1024 tokens; xlstm-125m: 12
    layers, d_model 768, max_len 1024, whole prompts (no extend), prompts
    of 16-512 tokens.  Both bf16 with seeded random weights made on the
    card, batch 8, 64 output tokens a request."""
    from repro_torch.configs import get_config
    from repro_torch.core.config import engine_scheduler_cfg
    from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine
    cfg = get_config(arch)
    if arch == ZAMBA_PATH:
        check(cfg.n_layers == 38 and cfg.d_model == 2048
              and cfg.d_head == 64, "zamba2-1.2b: not full width")
        max_len, sched, lo, hi = 2048, serve_scheduler(), 128, 1024
    else:
        check(cfg.n_layers == 12 and cfg.d_model == 768,
              "xlstm-125m: not full width")
        max_len, sched, lo, hi = 1024, engine_scheduler_cfg(8), 16, 512
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, max_batch=8, max_len=max_len, name="e0", seed=0)
    torch.cuda.synchronize()
    print(f"phase 7: {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, bf16, seeded random weights) made on the card in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    reqs = recurrent_requests(cfg.vocab, lo, hi)
    drv = ServeDriver([eng], DriverCfg(scheduler=sched))
    drv.runtime.warmup()
    return cfg, eng, drv, reqs


def serve_recurrent(torch, ops, card, arch):
    """Serve a recurrent model's 8 requests at full width: every request
    finishes with its tokens; zamba2-1.2b launches flash, paged decode and
    paged extend at H32 KV32 dh64, xlstm-125m no kernel of the repo.
    Returns the serve's launch counts."""
    cfg, eng, drv, reqs = recurrent_serve_setup(torch, arch)
    torch.cuda.reset_peak_memory_stats()
    seen, restore = _record_shapes(ops)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        m = drv.run(reqs, warmup=False)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(m["finished"] == len(reqs),
          f"{arch}: finished {m['finished']} of {len(reqs)}")
    backend = drv.runtime.instances["e0"].backend
    for r in drv.finished:
        toks = backend.out_tokens[r.req_id]
        check(len(toks) == r.output_len
              and all(0 <= t < cfg.vocab for t in toks),
              f"{arch} request {r.req_id}: {len(toks)} tokens of "
              f"{r.output_len}")
    if arch == ZAMBA_PATH:
        for name in ("flash_attention", "paged_attention_decode",
                     "paged_attention_extend"):
            check(launches[name] > 0,
                  f"{name} was not launched while serving {arch}")
        check(seen == ZAMBA_SHAPES, f"{arch}: the kernels saw {seen}")
    else:
        check(not any(launches.values()) and not seen,
              f"{arch} launched {launches}")
    ttft = statistics.median(r.ttft() for r in drv.finished)
    tpot = statistics.median(r.tpot() for r in drv.finished
                             if r.tpot() is not None)
    n_out = sum(r.output_len for r in drv.finished)
    print(f"serve [{card}] {cfg.name} 8 requests (prompts "
          f"{min(r.prompt_len for r in drv.finished)}-"
          f"{max(r.prompt_len for r in drv.finished)}, 64 output tokens "
          f"each, batch 8, "
          f"{'chunk 256' if arch == ZAMBA_PATH else 'whole prompts'}): "
          f"TTFT p50 {ttft * 1e3:.1f} ms, TPOT p50 {tpot * 1e3:.2f} ms, "
          f"{n_out / wall:.1f} output tok/s over wall {wall:.2f} s, peak "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if arch == ZAMBA_PATH:
        print(f"launches while serving {cfg.name}: {json.dumps(launches)}; "
              f"shapes {sorted(seen)} at head dim {cfg.d_head}")
    else:
        print(f"{cfg.name} launches no kernel of the repo (its mLSTM and "
              f"sLSTM run as PyTorch operations): {json.dumps(launches)}")
    del eng, drv, backend
    gc.collect()                # ServeDriver and its runtime form a cycle
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def plain_attention(ops):
    """Route the model's attention to the plain versions on the card: the
    wrappers never do that themselves (a CUDA tensor launches its kernel
    or raises)."""
    flash, paged = ops.flash_attention, ops.paged_attention
    ops.flash_attention = ops.flash_attention_plain
    ops.paged_attention = ops.paged_attention_plain
    try:
        yield
    finally:
        ops.flash_attention, ops.paged_attention = flash, paged


def zamba_f32_probe(torch, ops, card):
    """zamba2-1.2b at its published widths, f32, cut to one superblock,
    served on the card twice from the same weights: through the kernels
    and through their plain versions.  Every arrival at 0, so the
    decisions (and the chunks whose pad tails enter the state) do not
    depend on latencies: the decisions and tokens must be equal; the
    largest difference of the two routes' prefill logits is printed."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine
    cfg = depth_cut_f32(get_config(ZAMBA_PATH), layers=1)
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    reqs = recurrent_requests(cfg.vocab, 128, 1024, out=16, rate=None)

    def serve():
        eng = ServingEngine(cfg, params, max_batch=8, max_len=2048,
                            name="e0")
        drv = ServeDriver([eng], DriverCfg(scheduler=serve_scheduler()))
        ops.reset_launch_counts()
        m = drv.run([dataclasses.replace(r) for r in reqs], warmup=False)
        inst = drv.runtime.instances["e0"]
        out = (m["finished"], dict(inst.backend.out_tokens),
               list(inst.decisions), ops.launch_counts(),
               probe_logits(torch, eng, reqs))
        del eng, drv, inst
        gc.collect()
        return out
    kern = serve()
    with plain_attention(ops):
        plain = serve()
    check(kern[0] == plain[0] == len(reqs),
          f"zamba2 f32 probe: finished {kern[0]} / {plain[0]}")
    check(all(kern[3][n] > 0 for n in ("flash_attention",
                                       "paged_attention_decode",
                                       "paged_attention_extend"))
          and not any(plain[3].values()),
          f"zamba2 f32 probe: launches {kern[3]} / {plain[3]}")
    check(kern[2] == plain[2] and kern[1] == plain[1],
          "zamba2 f32 probe: the kernels' decisions or tokens differ from "
          "the plain versions'")
    err = float(abs(kern[4] - plain[4]).max())
    n_tok = sum(len(t) for t in kern[1].values())
    print(f"phase 7 [{card}]: zamba2-1.2b at published widths, f32, one "
          f"superblock: kernels == plain versions on the card in "
          f"{len(kern[2])} decisions and {n_tok} tokens; prefill logits "
          f"(B8 S128) differ by at most {err:.3g}")
    del params
    torch.cuda.empty_cache()


def recurrent_on_card(torch, ops, card):
    """Phase 7: the recurrent and hybrid families (launch counts by
    path)."""
    t0 = time.perf_counter()
    by_path = {ZAMBA_PATH: serve_recurrent(torch, ops, card, ZAMBA_PATH)}
    zamba_f32_probe(torch, ops, card)
    by_path[XLSTM_PATH] = serve_recurrent(torch, ops, card, XLSTM_PATH)
    print(f"phase 7: ran {time.perf_counter() - t0:.1f} s")
    return by_path


# ---------------------------------------------------------------- phase 8
#: tiny f32 training, card against CPU: losses rtol 1e-4; params rtol 1e-3,
#: atol 1e-4 (three AdamW steps over sums in other orders), except entries
#: whose gradient sits within a few of Adam's eps (1e-8) of zero, which
#: move by up to ~lr a step whatever their last bits: at most one, or 1 in
#: 1000, a leaf, held to 2 * lr * steps
TINY_TRAIN_LR = 1e-2
TINY_TRAIN_STEPS = 3
#: resume against the uninterrupted run (the same seeded data and
#: schedule): losses rtol 1e-5, params as above
RESUME_RTOL = 1e-5


def _params_close(got, want, lr, steps, rtol=1e-3, atol=1e-4):
    """(ok, max abs difference) of two lists of param tensors under the
    tiny-training rule above."""
    worst, ok = 0.0, True
    for a, b in zip(got, want):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        d = (a - b).abs()
        off = d > atol + rtol * b.abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        ok = ok and int(off.sum()) <= max(1, a.numel() // 1000) \
            and bool((d <= 2 * lr * steps).all())
    return ok, worst


def _tiny_batches(cfg, B=4, S=32, n=TINY_TRAIN_STEPS, seed=12):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if cfg.embed_inputs:
            inputs = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        else:
            inputs = rng.standard_normal((B, S, cfg.d_model)).astype(
                np.float32)
        shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
        labels = rng.integers(0, cfg.vocab, shape).astype(np.int32)
        out.append({"inputs": torch.from_numpy(inputs),
                    "labels": torch.from_numpy(labels)})
    return out


def _tiny_train(torch, cfg, params_cpu, batches, dev):
    """Three AdamW steps at ``microbatches=2`` with remat on: (losses,
    the final param leaves)."""
    from repro_torch.models import Model
    from repro_torch.train import (AdamW, TrainState, TrainStepConfig,
                                   make_train_step)
    from repro_torch.train.tree import leaves, map_tree
    model = Model(cfg, remat=True)
    opt = AdamW(lr=TINY_TRAIN_LR)
    params = map_tree(lambda t: t.detach().to(dev).clone(), params_cpu)
    state = TrainState(params, opt.init(params))
    step = make_train_step(model, opt, TrainStepConfig(microbatches=2))
    losses = []
    for b in batches:
        state, m = step(state, {k: v.to(dev) for k, v in b.items()})
        losses.append(float(m["loss_total"]))
    return losses, leaves(state.params)


def _musicgen_tiny_logits(torch, cfg, params_cpu, dev):
    """Tiny musicgen on embeddings: a prefill (two rows, one ragged), then
    a paged extend of the same embeddings from empty slots and two decode
    steps; every call's logits on the host."""
    import numpy as np
    from repro_torch.models import Model
    from repro_torch.train.tree import map_tree
    rng = np.random.default_rng(13)
    m = Model(cfg, page_size=16)
    params = map_tree(lambda t: t.detach().to(dev), params_cpu)
    B, S, max_len = 2, 24, 64
    emb = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(
        np.float32)).to(dev)
    n = torch.tensor([24, 13], dtype=torch.int32, device=dev)
    out = []
    with torch.no_grad():
        logits, _ = m.prefill(params, emb, lengths=n)
        out.append(logits)
        cache = m.init_cache(B, max_len, device=dev)
        maxp, _ = m.page_geometry(B, max_len)
        cache["block_table"] = torch.arange(
            B * maxp, dtype=torch.int32, device=dev).reshape(B, maxp)
        logits, cache = m.extend(params, cache, emb, n)
        out.append(logits)
        for _ in range(2):
            e1 = torch.from_numpy(rng.standard_normal(
                (B, 1, cfg.d_model)).astype(np.float32)).to(dev)
            logits, cache = m.decode(params, cache, e1)
            out.append(logits)
    return [x.cpu() for x in out]


def _gmm_per_layer(cfg):
    """Grouped matmul launches a model call: 3 a MoE layer (gate, up, down;
    up and down for GELU experts), 0 for a model without experts."""
    if cfg.moe is None:
        return 0
    return (3 if cfg.mlp_gated else 2) * sum(st.n_layers for st in cfg.stages)


def tiny_training_card_matches_cpu(torch, ops, dev,
                                   archs=("llama3.1-8b-tiny",
                                          "musicgen-large-tiny")):
    """(a), and (e) for the MoE archs: tiny f32 models train on the card as
    on the CPU; tiny musicgen's prefill, extend and decode on embeddings
    too.  A tiny MoE arch keeps its published expert count and top-k (the
    tiny configs all route 4 experts top-2), so granite-moe-3b-a800m
    dispatches top-8 over 40; its card run must launch the grouped matmul's
    backward once a product a MoE layer a microbatch, its forward twice
    (remat)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
        if cfg.moe is not None:
            full = get_config(arch.removesuffix("-tiny")).moe
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, n_experts=full.n_experts, top_k=full.top_k))
        params = Model(cfg).init(torch.Generator().manual_seed(0))
        batches = _tiny_batches(cfg)
        ops.reset_launch_counts()
        lc, pc = _tiny_train(torch, cfg, params, batches, dev)
        counts = ops.launch_counts()
        lg, pg = _tiny_train(torch, cfg, params, batches,
                             torch.device("cpu"))
        n = _gmm_per_layer(cfg) * TINY_TRAIN_STEPS * 2
        check(counts["moe_gmm_bwd"] == n and counts["moe_gmm"] == 2 * n,
              f"tiny {arch} training on the card launched moe_gmm "
              f"{counts['moe_gmm']} and moe_gmm_bwd {counts['moe_gmm_bwd']} "
              f"times; want {2 * n} and {n}")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lg))
        ok, perr = _params_close(pc, pg, TINY_TRAIN_LR, TINY_TRAIN_STEPS)
        print(f"phase 8: tiny {arch} f32, {TINY_TRAIN_STEPS} AdamW steps, "
              f"microbatches 2, remat on: card == CPU, losses "
              f"{[round(x, 5) for x in lc]} (max rel err {loss_err:.2g} | "
              f"1e-4), params max abs err {perr:.3g} (rtol 1e-3, atol 1e-4 "
              f"but Adam's ill-conditioned entries)"
              + (f"; E{cfg.moe.n_experts} top-{cfg.moe.top_k}, moe_gmm "
                 f"{counts['moe_gmm']}, moe_gmm_bwd {counts['moe_gmm_bwd']} "
                 f"launches" if n else ""))
        check(loss_err <= 1e-4 and ok,
              f"tiny {arch} training: card differs from the CPU (losses "
              f"{lc} vs {lg}, params max err {perr})")
        if arch.startswith("musicgen"):
            got = _musicgen_tiny_logits(torch, cfg, params, dev)
            want = _musicgen_tiny_logits(torch, cfg, params,
                                         torch.device("cpu"))
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            check(all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                      for a, b in zip(got, want)),
                  f"tiny musicgen logits on embeddings: card differs from "
                  f"the CPU ({err})")
            print(f"phase 8: tiny musicgen f32 on embeddings (prefill, "
                  f"paged extend, 2 decodes; logits {tuple(got[0].shape)}): "
                  f"card == CPU, max abs err {err:.3g} (tol 1e-4)")


def demo_training(torch, ops, card):
    """(b): demo-110m at full width through the trainer's function, 40
    steps at B8 S1024 checkpointing at 20, then a resume from step 20's
    checkpoint to 40 against the uninterrupted run.  Returns the first
    run's launch counts."""
    from repro_torch.launch import train as trainer
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.tree import leaves
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    a, b = root / "a", root / "b"
    cfg = trainer.DEMO_110M
    steps, B, S = 40, 8, 1024
    kw = dict(steps=steps, batch=B, seq=S, ckpt_every=20, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run = trainer.train(cfg.name, ckpt_dir=str(a),
                        log=lambda m: print(f"  {m}"), **kw)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = run["losses"]
    L = cfg.n_layers
    check(counts["flash_attention"] == L * steps
          and counts["flash_attention_bwd"] == L * steps,
          f"demo-110m training launched flash {counts['flash_attention']} "
          f"and its backward {counts['flash_attention_bwd']} times; "
          f"{L} layers x {steps} steps = {L * steps} each")
    check(all(x == x for x in losses) and losses[-1] < losses[0],
          f"demo-110m: the loss did not fall ({losses[0]} -> {losses[-1]})")
    step_s = statistics.median(run["step_s"][1:])
    print(f"phase 8 [{card}] {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, H{cfg.n_heads} KV{cfg.n_kv_heads} dh{cfg.d_head}, "
          f"vocab {cfg.vocab}, bf16 compute, f32 params), B{B} S{S}, "
          f"{steps} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
          f"time p50 {step_s * 1e3:.1f} ms (first step {run['step_s'][0]:.2f}"
          f" s), {B * S / step_s:.0f} tokens/s, peak memory {peak:.2f} GiB, "
          f"{wall:.1f} s with 2 checkpoints; launches "
          f"{json.dumps(counts)}")
    b.mkdir(parents=True)
    shutil.copytree(a / "step_0000000020", b / "step_0000000020")
    res = trainer.train(cfg.name, ckpt_dir=str(b), resume=True,
                        log=lambda m: None, **kw)
    check(res["start"] == 20 and len(res["losses"]) == steps - 20,
          f"demo-110m resume started at {res['start']}")
    loss_err = max(abs(x - y) / abs(y) for x, y in
                   zip(res["losses"], losses[20:]))
    full = ckpt.restore(str(a), steps, res["state"])
    ok, perr = _params_close(leaves(res["state"].params),
                             leaves(full.params), 3e-3, 20)
    bitwise = all(torch.equal(x.detach(), y.detach()) for x, y in
                  zip(leaves(res["state"]), leaves(full)))
    print(f"phase 8: {cfg.name} resumed from step 20 to {steps}: final loss "
          f"{res['losses'][-1]:.6f} vs {losses[-1]:.6f} uninterrupted, "
          f"losses max rel diff {loss_err:.3g} (tol {RESUME_RTOL}), params "
          f"max abs diff {perr:.3g}; bitwise equal: {bitwise}")
    check(loss_err <= RESUME_RTOL and ok,
          f"demo-110m: the resumed run ends elsewhere ({loss_err}, {perr})")
    shutil.rmtree(root, ignore_errors=True)
    return counts


def _depth_cut(cfg, layers):
    return dataclasses.replace(
        cfg, n_layers=layers,
        stages=(dataclasses.replace(cfg.stages[0], n_layers=layers),))


def full_width_training(torch, ops, card, arch, layers, B, S, steps=3):
    """(c), (d) and (f): ``arch`` at published widths cut to ``layers``,
    bf16 compute, f32 params and moments, remat on, ``steps`` AdamW steps
    on seeded data (token ids, or bf16 embeddings for musicgen).  Returns
    the run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import (AdamW, init_state, make_train_step)
    from repro_torch.train.tree import leaves
    from repro_torch.workload.datasets import DataConfig, token_batches
    dev = torch.device("cuda")
    cfg = _depth_cut(get_config(arch), layers)
    model = Model(cfg, remat=True)
    opt = AdamW(lr=3e-4)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_state(model, opt, gen, device=dev)
    n_params = sum(p.numel() for p in leaves(state.params))
    step_fn = make_train_step(model, opt)
    data = token_batches(DataConfig(vocab=cfg.vocab, batch=B, seq_len=S,
                                    seed=0)) if cfg.embed_inputs else None
    ops.reset_launch_counts()
    losses, times, nonzero = [], [], None
    for i in range(steps):
        if data is not None:
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(data).items()}
        else:
            batch = {"inputs": torch.randn((B, S, cfg.d_model), generator=gen,
                                           device=dev).to(torch.bfloat16),
                     "labels": torch.randint(0, cfg.vocab,
                                             (B, S, cfg.n_codebooks),
                                             generator=gen, device=dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        if i == 0:   # the first moments are (1 - b1) * the clipped grads
            nonzero = [bool(mu.any()) for mu in leaves(state.opt.mu)]
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in losses),
          f"{arch} training: a loss is not finite ({losses})")
    check(all(nonzero), f"{arch} training: {nonzero.count(False)} gradient "
                        f"leaves are all zero")
    check(counts["flash_attention"] == 2 * layers * steps
          and counts["flash_attention_bwd"] == layers * steps,
          f"{arch} training launched flash {counts['flash_attention']} and "
          f"its backward {counts['flash_attention_bwd']} times; want "
          f"{2 * layers * steps} (remat recomputes the forward) and "
          f"{layers * steps}")
    n = _gmm_per_layer(cfg) * steps
    check(counts["moe_gmm"] == 2 * n and counts["moe_gmm_bwd"] == n,
          f"{arch} training launched moe_gmm {counts['moe_gmm']} and "
          f"moe_gmm_bwd {counts['moe_gmm_bwd']} times; want {2 * n} (remat "
          f"recomputes the forward) and {n}")
    reckon = n_params * 16 / 2 ** 30
    print(f"phase 8 [{card}] {arch} at published widths cut to {layers} "
          f"layers ({n_params / 1e9:.3f} B params), bf16 compute, f32 params "
          f"and moments, remat on, B{B} S{S}, {steps} steps: losses "
          f"{[round(x, 4) for x in losses]}, every gradient leaf nonzero; "
          f"step times {[round(t, 3) for t in times]} s; peak memory "
          f"{peak:.2f} GiB (params, grads and two moments: {reckon:.2f} "
          f"GiB); launches {json.dumps(counts)}")
    ln_v = math.log(cfg.vocab)
    check(abs(losses[0] - ln_v) < 1.0,
          f"{arch}: step 0's loss {losses[0]} is not near ln {cfg.vocab} = "
          f"{ln_v:.3f}")
    print(f"  step 0's loss {losses[0]:.4f} against ln {cfg.vocab} = "
          f"{ln_v:.4f} (unit-variance logits add ~0.4)")
    del state, step_fn, model
    return counts


def training_on_card(torch, ops, card):
    """Phase 8; returns the launch counts by training path."""
    t0 = time.perf_counter()
    tiny_training_card_matches_cpu(torch, ops, torch.device("cuda"))
    by_path = {TRAIN_PATH: demo_training(torch, ops, card)}
    gc.collect()
    torch.cuda.empty_cache()
    by_path[TRAIN_LLAMA_PATH] = full_width_training(
        torch, ops, card, "llama3.1-8b", 2, 2, 1024)
    gc.collect()
    torch.cuda.empty_cache()
    by_path[TRAIN_MUSICGEN_PATH] = full_width_training(
        torch, ops, card, "musicgen-large", 4, 4, 1024)
    gc.collect()
    torch.cuda.empty_cache()
    tiny_training_card_matches_cpu(
        torch, ops, torch.device("cuda"),
        ("phimini-moe-tiny", "granite-moe-3b-a800m-tiny"))
    by_path[TRAIN_MOE_PATH] = full_width_training(
        torch, ops, card, "phimini-moe", 2, 2, 1024)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 8: ran {time.perf_counter() - t0:.1f} s")
    return by_path


# ---------------------------------------------------------------- phase 9
#: phase 9's steps, each first counted on meta by the dry run's machinery
#: and then run on the card: (label, arch, layers (None: full depth),
#: step, batch, tokens a row, max_len, tokens each slot holds before it)
DRYRUN_STEPS = (
    ("dry run: train llama3.1-8b (2 layers) B2 S1024", "llama3.1-8b", 2,
     "train", 2, 1024, None, None),
    ("dry run: train phimini-moe (2 layers) B2 S1024", "phimini-moe", 2,
     "train", 2, 1024, None, None),
    ("dry run: prefill llama3.1-8b B1 S2048", "llama3.1-8b", None,
     "prefill", 1, 2048, None, None),
    ("dry run: extend llama3.1-8b B1 S256 after 1792", "llama3.1-8b", None,
     "extend", 1, 256, 2048, 1792),
    ("dry run: decode llama3.1-8b B8 at 2047 of 2048", "llama3.1-8b", None,
     "decode", 8, 1, 2048, 2047),
)
#: the card's peak allocation over the dry run's predicted peak
PEAK_BAND = (0.9, 1.1)


def _dry_inputs(torch, model, step, B, S, max_len, held, device,
                params=None, gen=None):
    """A phase 9 step's inputs: the dry run's meta specs, or seeded ones
    on the card (f32 params and AdamW state for a train step; bf16 params
    otherwise, and for extend and decode a cache whose every slot holds
    ``held`` tokens through an identity block table)."""
    from repro_torch.launch import specs
    from repro_torch.train import AdamW, init_state
    cfg = model.cfg
    meta = device == "meta"

    def ids(shape):
        if meta:
            return torch.empty(shape, dtype=torch.int32, device=device)
        return torch.randint(0, cfg.vocab, shape, generator=gen,
                             device=device, dtype=torch.int32)
    if step == "train":
        state = specs.state_specs(model, AdamW()) if meta \
            else init_state(model, AdamW(), gen, device=device)
        return {"state": state,
                "batch": {"inputs": ids((B, S)), "labels": ids((B, S))}}
    if params is None:
        params = specs.params_specs(model, torch.bfloat16) if meta \
            else model.init(gen, device=device, dtype=torch.bfloat16)
    if step == "prefill":
        return {"params": params, "tokens": ids((B, S))}
    cache = model.init_cache(B, max_len, device=device)
    if not meta:
        maxp, _ = model.page_geometry(B, max_len)
        cache["block_table"] = torch.arange(
            B * maxp, dtype=torch.int32, device=device).reshape(B, maxp)
        cache["lengths"] = torch.full((B,), held, dtype=torch.int32,
                                      device=device)
    return {"params": params, "cache": cache, "tokens": ids((B, S))}


def _state_part(inputs):
    """What phase 9 holds exactly: params and optimizer state."""
    return inputs.get("state", inputs.get("params"))


def _card_peak(torch, model, step, inputs):
    """The card's peak allocation over one step, with what was allocated
    before it other than the step's inputs taken out; the decode
    workspace dropped first, so the step allocates it as the dry run's
    does."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import dryrun
    pa._SCRATCH.pop(torch.device("cuda", 0), None)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = dryrun.run_step(model, step, inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return peak - base + dryrun.state_bytes(inputs)


def _card_ms(torch, model, step, inputs, reps):
    """Median wall ms of ``reps`` steps, each ended by a synchronize."""
    from repro_torch.launch import dryrun
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dryrun.run_step(model, step, inputs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del out
    return statistics.median(times)


def dryrun_on_card(torch, ops, card):
    """Phase 9: each step of ``DRYRUN_STEPS`` counted on meta by the dry
    run (``repro_torch.launch.dryrun.count_step``), then run on the card:
    params and optimizer state equal in bytes, every kernel launched as
    often as predicted, the FLOPs outside the kernels equal (counted over
    the card run), the peak allocation within ``PEAK_BAND`` of the
    predicted peak; the median step time printed beside the roofline's
    bound, no gate (activations under the 50 MB L2 make the per-op HBM
    bytes no strict floor).  Returns the launch counts by step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import Model
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    by_path, shared = {}, {}
    for label, arch, layers, step, B, S, max_len, held in DRYRUN_STEPS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = _depth_cut(cfg, layers)
        model = Model(cfg, remat=True)
        # the dry run on meta
        t1 = time.perf_counter()
        meta_in = _dry_inputs(torch, model, step, B, S, max_len, held,
                              "meta", params=shared.get("meta"))
        mc, mem, _ = dryrun.count_step(model, step, meta_in)
        rec = dryrun.record(mc, mem)
        meta_s = time.perf_counter() - t1
        # the same step on the card
        gen = torch.Generator(device=dev).manual_seed(0)
        card_in = _dry_inputs(torch, model, step, B, S, max_len, held, dev,
                              params=shared.get("card"), gen=gen)
        if step != "train" and layers is None:
            shared.setdefault("meta", meta_in["params"])
            shared.setdefault("card", card_in["params"])
        want_state = dryrun.state_bytes(_state_part(meta_in))
        got_state = dryrun.state_bytes(_state_part(card_in))
        check(got_state == want_state,
              f"{label}: params and optimizer state {got_state} bytes on "
              f"the card, {want_state} predicted")
        check(dryrun.state_bytes(card_in) == dryrun.state_bytes(meta_in),
              f"{label}: the step's inputs differ in bytes from the dry "
              f"run's")
        ops.reset_launch_counts()
        cc, _, out = dryrun.count_step(model, step, card_in)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        del out
        want_launch = {k: mc.launches().get(k, 0) for k in launches}
        check(launches == want_launch,
              f"{label}: the card launched {launches}; the dry run "
              f"predicted {want_launch}")
        check(cc.flops == mc.flops,
              f"{label}: {cc.flops:.6g} FLOPs outside the kernels on the "
              f"card, {mc.flops:.6g} predicted")
        peak = _card_peak(torch, model, step, card_in)
        ratio = peak / mem["peak_bytes"]
        ms = _card_ms(torch, model, step, card_in, 3 if step == "train"
                      else 5)
        roof = rec["roofline"]
        bound_ms = max(roof["t_compute_s"], roof["t_memory_s"]) * 1e3
        charged = {k: (round(mc.kernels[k].flops / 1e9, 3),
                       round(cc.kernels[k].flops / 1e9, 3))
                   for k in sorted(mc.kernels)}
        print(f"phase 9 [{card}] {label}: dry run {meta_s:.1f} s on meta; "
              f"params + state {got_state} bytes (== predicted); launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})} (== "
              f"predicted); FLOPs outside the kernels {cc.flops:.6g} (== "
              f"predicted), kernels' GFLOPs charged (meta, card data) "
              f"{charged}; peak {peak / 2 ** 30:.3f} GiB, predicted "
              f"{mem['peak_bytes'] / 2 ** 30:.3f} GiB (argument "
              f"{mem['argument_size_in_bytes'] / 2 ** 30:.3f}, temp "
              f"{mem['temp_size_in_bytes'] / 2 ** 30:.3f}), ratio "
              f"{ratio:.4f}; step p50 {ms:.2f} ms, roofline bound "
              f"{bound_ms:.2f} ms ({roof['bottleneck']}; compute "
              f"{roof['t_compute_s'] * 1e3:.2f}, memory "
              f"{roof['t_memory_s'] * 1e3:.2f}), bound / time "
              f"{bound_ms / ms:.3f}")
        check(PEAK_BAND[0] <= ratio <= PEAK_BAND[1],
              f"{label}: peak {peak} bytes on the card against "
              f"{mem['peak_bytes']} predicted (ratio {ratio:.4f}, band "
              f"{PEAK_BAND})")
        by_path[label] = launches
        del card_in, meta_in, cc, mc
        if step == "train":
            gc.collect()
            torch.cuda.empty_cache()
    shared.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 9: ran {time.perf_counter() - t0:.1f} s")
    return by_path


#: what the kernels without a Pallas counterpart replace: the JAX package
#: trains through plain JAX
REPLACES_NOTE = {
    "flash_attention_bwd": ("the JAX package's custom VJP in plain JAX, not "
                            "a Pallas kernel"),
    "moe_gmm_bwd": ("XLA autodiff of the JAX package's einsum branch, not a "
                    "Pallas kernel"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    try:
        card = card_and_setup(torch)
        worst = kernels_vs_plain(torch, ops, dev)
        times = timings(torch, ops, dev)
        untimed = set(ops.KERNELS) - {t["kernel"] for t in times.values()}
        check(not untimed, f"no phase-3 time for {sorted(untimed)}")
        torch.cuda.empty_cache()
        tiny_card_matches_cpu(torch)
        tiny_prefix_and_spec_card_matches_cpu(torch)
        by_path, probes = {}, {}
        for arch, must in PATHS:
            by_path[arch], probes[arch] = serve_full(torch, ops, card, arch,
                                                     must)
            gc.collect()          # ServeDriver and its runtime form a cycle
            torch.cuda.empty_cache()
        by_path[SPEC_PATH] = spec_serve_full(torch, ops, card)
        gc.collect()
        torch.cuda.empty_cache()
        traces = {}
        for arch, _ in PATHS:
            traces[arch], by_path[f"profile {arch}"] = profile_card(
                torch, ops, arch)
            gc.collect()
            torch.cuda.empty_cache()
        by_path.update(fidelity_card(torch, ops, card, traces)[0])
        tiny_decisions_card_equal_sim(torch)
        gc.collect()
        torch.cuda.empty_cache()
        tenants_on_card(torch)
        by_path.update(tp2_on_card(torch, card, probes))
        gc.collect()
        torch.cuda.empty_cache()
        by_path.update(recurrent_on_card(torch, ops, card))
        gc.collect()
        torch.cuda.empty_cache()
        by_path.update(training_on_card(torch, ops, card))
        by_path.update(dryrun_on_card(torch, ops, card))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    rows = []
    for name, t in times.items():           # one row per timed shape
        kernel = t["kernel"]
        source, replaces = ops.KERNELS[kernel]
        # each kernel's launches on the first path that needs it, or on
        # the path its row names (the verify shape: the spec serve)
        path = t.get("path") or next(a for a, must in PATHS
                                     if kernel in must)
        row = {}
        if kernel in REPLACES_NOTE:
            row["replaces_note"] = REPLACES_NOTE[kernel]
        if "split_ms" in t:
            row["split_ms"] = t["split_ms"]
        rows.append({"name": name, "kernel": kernel, "shape": t["shape"],
                     "route": "cuda", "source": source,
                     "replaces": replaces, **row,
                     "launches": by_path[path][kernel],
                     "launches_by_path": {a: n[kernel]
                                          for a, n in by_path.items()},
                     "max_abs_err": worst[kernel], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                     "bound_by": t["bound"][1],
                     "library_ms": t["library_ms"],
                     "host_us": t["host_us"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
