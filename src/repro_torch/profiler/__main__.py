"""Profiler CLI: the paper's single-command hardware integration.

The port of ``repro/profiler/__main__.py``.  Emit a portable
``HardwareTrace`` artifact for one device, measured through the port's
``TorchBackend`` on a torch device, or synthesized from a hardware spec
for a device that is not at hand:

  # measure the card through the real engine, with the kernel sweep
  python -m repro_torch.profiler profile --device h100 --mode measured \\
      --arch llama3.1-8b --kernels --out traces/h100.json

  # measure on the CPU (tiny archs)
  python -m repro_torch.profiler profile --device cpu-engine \\
      --arch llama3.1-8b-tiny

  # synthesize a never-measured accelerator from its spec sheet
  python -m repro_torch.profiler profile --device tpu-v6e \\
      --arch llama3.1-8b-tiny --out traces/tpu-v6e.json

``--engine-device`` names the torch device the engine runs on (default:
the CPU for a CPU label such as ``cpu-engine``, ``cpu-measured`` or
``local``, else the card); ``--device`` (``--hw`` for ``ops``) is the
artifact's label, and a run on the card refuses a CPU label.  The grid flags
(``--prefill-buckets``, ``--decode-ctxs``, ``--extend-ctxs``,
``--extend-suffixes``) default to the JAX package's grid.  The artifact
loads via ``repro_torch.hw`` and is referenced from cluster configs by
``InstanceCfg(hw_name="<device>")``.

MoE architectures have a second artifact, the expert-routing trace
(``record-routing``, or ``profile --experts``), and speculative decoding a
third, the acceptance trace (``spectrace/1``):

  # record draft/target acceptance through a speculating engine
  python -m repro_torch.profiler record-acceptance \\
      --arch llama3.1-8b-tiny --engine-device cpu --k 4

  # or synthesize it from a per-token acceptance rate
  python -m repro_torch.profiler record-acceptance \\
      --arch llama3.1-8b-tiny --mode synthetic --alpha 0.7

  # ride along with a hardware profile
  python -m repro_torch.profiler profile --device cpu-engine \\
      --arch llama3.1-8b-tiny --spec

Measured tensor-parallel grids: ``--tp 1,2`` measures one grid per degree
into one artifact, as the JAX CLI does; a point at tp = k runs k ranks
(``repro_torch.launch.mesh.run_ranks``) on k devices of the engine's kind,
one card a rank over NCCL or k processes on the CPU over gloo.  Fewer
visible cards than k exit with a message naming both counts.

  python -m repro_torch.profiler profile --device cpu-engine --tp 1,2 \\
      --arch llama3.1-8b-tiny --out traces/cpu-engine.json

The operator-level profiler (raw ``Trace``) is the ``ops`` subcommand; a
bare ``python -m repro_torch.profiler --arch ...`` means ``ops``.
"""
import argparse
import json
import sys


def _parse_ints(value, flag) -> list:
    """``--tp 1,2`` -> sorted unique integers [1, 2]."""
    if isinstance(value, int):
        value = str(value)
    try:
        out = sorted({int(t) for t in value.split(",") if t.strip()})
    except ValueError:
        raise SystemExit(
            f"{flag} expects comma-separated integers (e.g. {flag} 1,2), "
            f"got {value!r}") from None
    if not out:
        raise SystemExit(f"{flag} needs at least one value")
    if out[0] < 1:
        raise SystemExit(f"{flag} values must be >= 1, got {out[0]}")
    return out


def _grid(args) -> dict:
    return {name: tuple(_parse_ints(getattr(args, name),
                                    "--" + name.replace("_", "-")))
            for name in ("prefill_buckets", "decode_ctxs", "extend_ctxs",
                         "extend_suffixes")}


def _engine_device(args, label):
    """``--engine-device``, else the CPU for a CPU label, else None (the
    card)."""
    from repro_torch.profiler.runtime_profiler import is_cpu_label
    if args.engine_device is None and label is not None \
            and is_cpu_label(label):
        return "cpu"
    return args.engine_device


def _cmd_profile(args):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.config import HardwareSpec
    from repro_torch.hw import HardwareRegistry, get_hw, register_hw
    from repro_torch.profiler.arch_spec import model_spec_from_arch
    spec_flags = {k: getattr(args, k) for k in
                  ("peak_flops", "hbm_bw", "hbm_capacity", "link_bw")}
    if any(v is not None for v in spec_flags.values()):
        missing = [k for k, v in spec_flags.items() if v is None]
        if missing:
            raise SystemExit(
                f"defining a new device spec needs all of --peak-flops "
                f"--hbm-bw --hbm-capacity --link-bw (missing: "
                f"{', '.join('--' + m.replace('_', '-') for m in missing)})")
        register_hw(HardwareSpec(
            name=args.device,
            mmu_efficiency=args.mmu_efficiency
            if args.mmu_efficiency is not None else 0.85,
            **spec_flags))
    elif args.mmu_efficiency is not None:
        # derate/uprate a known spec without redefining the whole device
        register_hw(dataclasses.replace(
            get_hw(args.device), mmu_efficiency=args.mmu_efficiency))

    tps = _parse_ints(args.tp, "--tp")
    mode = args.mode
    if mode == "auto":
        mode = "measured" if args.device in ("cpu-engine", "local") \
            else "synthetic"
    if mode == "measured":
        import torch

        from repro_torch.launch.mesh import visible_devices
        from repro_torch.profiler.runtime_profiler import (runtime_trace,
                                                           runtime_trace_tp)
        grid = _grid(args)
        engine_device = _engine_device(args, args.device)
        kind = torch.device(engine_device or "cuda").type
        n = visible_devices(kind)
        if max(tps) > 1 and n is not None and n < max(tps):
            raise SystemExit(
                f"--tp {args.tp}: a measured point at tp={max(tps)} runs "
                f"{max(tps)} ranks on {max(tps)} {kind} devices, but {n} "
                f"are visible")
        kw = dict(device=args.device, max_batch=args.max_batch,
                  max_len=args.max_len, reps=args.reps, seed=args.seed,
                  engine_device=engine_device, **grid)
        hwt, wall = None, 0.0
        for tp in tps:
            one = runtime_trace(args.arch, **kw) if tp == 1 \
                else runtime_trace_tp(args.arch, tp, **kw)
            wall += one.meta.get("profile_wall_s", 0.0)
            hwt = one if hwt is None else hwt.merge(one)
        # merge() keeps the first probe's meta; restate artifact-wide facts
        hwt.meta["profile_wall_s"] = wall
        hwt.meta.pop("tp", None)
        if args.kernels is not None:
            # hwtrace/3 kernel sub-buckets: per-kernel rows per backend on
            # the base grid (one device; the perf model composes tp
            # collectives analytically on top)
            from repro_torch.profiler.kernel_profiler import add_kernel_grid
            backends = [b for b in args.kernels.split(",") if b.strip()]
            add_kernel_grid(hwt, args.arch, backends,
                            device=engine_device,
                            max_batch=args.max_batch, max_len=args.max_len,
                            reps=args.reps, seed=args.seed,
                            prefill_buckets=grid["prefill_buckets"],
                            decode_ctxs=grid["decode_ctxs"])
    else:
        if args.kernels is not None:
            raise SystemExit(
                "--kernels sweeps real kernels and needs measured mode "
                "(--device cpu-engine/local, or --mode measured)")
        from repro_torch.hw.synthetic import synthetic_trace
        hwt = synthetic_trace(get_hw(args.device),
                              model_spec_from_arch(get_config(args.arch)),
                              tp=tps, device=args.device)
    hwt.meta["tp_degrees"] = hwt.tp_degrees()
    hwt.meta["n_points"] = sum(
        len(hwt.grid(t)) for t in hwt.tp_degrees())
    out = args.out or f"traces/{args.device}.json"
    hwt.save(out)
    # round-trip through the registry so a broken artifact fails HERE,
    # not at simulation time
    HardwareRegistry().load_file(out)
    summary = {"trace": out, "device": hwt.device,
               "model": hwt.model, **hwt.meta}
    if args.experts is not None:
        rout = args.experts if args.experts != "auto" \
            else f"traces/{args.device}.routing.json"
        summary["routing_trace"] = _emit_routing(
            args, out=rout, synthetic=(mode != "measured"))
    if args.spec is not None:
        acc = args.spec if args.spec != "auto" \
            else f"traces/{args.device}.acceptance.json"
        summary["acceptance_trace"] = _emit_acceptance(
            args, out=acc, synthetic=(mode != "measured"))
    print(json.dumps(summary, indent=1))
    return summary


def _emit_routing(args, out: str, synthetic: bool) -> str:
    """Shared by ``profile --experts`` and ``record-routing``: emit (and
    round-trip check) one ExpertRoutingTrace artifact for ``args.arch``."""
    from repro_torch.configs import get_config
    from repro_torch.moe import RoutingRegistry, moe_layer_count

    cfg = get_config(args.arch)
    if cfg.moe is None:
        raise SystemExit(
            f"--arch {args.arch} is not a MoE architecture; expert-routing "
            f"traces need one (e.g. granite-moe-1b-a400m-tiny)")
    if synthetic:
        from repro_torch.workload.expert_skew import (SkewConfig,
                                                      synthesize_routing)
        trace = synthesize_routing(
            moe_layer_count(cfg), cfg.moe.n_experts, cfg.moe.top_k,
            SkewConfig(kind=getattr(args, "skew", "zipf"),
                       zipf_a=getattr(args, "zipf_a", 1.1),
                       period=args.period, seed=args.seed),
            model=cfg.name)
    else:
        from repro_torch.moe.record import record_routing
        trace = record_routing(
            args.arch, n_requests=getattr(args, "requests", 8),
            max_batch=args.max_batch, max_len=args.max_len,
            period=args.period, seed=args.seed,
            device=_engine_device(args, getattr(args, "device", None)))
    trace.save(out)
    RoutingRegistry().load_file(out)   # broken artifacts fail at emit time
    return out


def _emit_acceptance(args, out: str, synthetic: bool) -> str:
    """Shared by ``profile --spec`` and ``record-acceptance``: emit (and
    round-trip check) one AcceptanceTrace artifact for ``args.arch``."""
    from repro_torch.spec import AcceptanceRegistry

    k = getattr(args, "k", 4)
    if synthetic:
        from repro_torch.workload.acceptance import (AcceptanceConfig,
                                                     synthesize_acceptance)
        trace = synthesize_acceptance(
            AcceptanceConfig(alpha=getattr(args, "alpha", 0.7), k=k,
                             period=args.period,
                             jitter=getattr(args, "jitter", 0.0),
                             seed=args.seed),
            model=args.arch)
    else:
        from repro_torch.spec import record_acceptance
        trace = record_acceptance(
            args.arch, getattr(args, "draft_arch", None), k=k,
            n_requests=getattr(args, "requests", 8),
            max_batch=args.max_batch, max_len=args.max_len,
            period=args.period, seed=args.seed,
            draft_seed=getattr(args, "draft_seed", 1),
            device=_engine_device(args, getattr(args, "device", None)))
    trace.save(out)
    AcceptanceRegistry().load_file(out)  # broken artifacts fail at emit
    return out


def _cmd_record_routing(args):
    out = _emit_routing(args,
                        out=args.out or f"traces/{args.arch}.routing.json",
                        synthetic=(args.mode == "synthetic"))
    from repro_torch.moe import ExpertRoutingTrace
    trace = ExpertRoutingTrace.load(out)
    summary = {"trace": out, "model": trace.model,
               "n_layers": trace.n_layers, "n_experts": trace.n_experts,
               "top_k": trace.top_k,
               "static_imbalance": trace.static_imbalance(), **trace.meta}
    print(json.dumps(summary, indent=1))
    return summary


def _cmd_record_acceptance(args):
    out = _emit_acceptance(
        args, out=args.out or f"traces/{args.arch}.acceptance.json",
        synthetic=(args.mode == "synthetic"))
    from repro_torch.spec import AcceptanceTrace
    trace = AcceptanceTrace.load(out)
    summary = {"trace": out, "model": trace.model, "draft": trace.draft,
               "k": trace.k, "period": trace.period,
               "mean_accepted": trace.mean_accepted(),
               "acceptance_rate": trace.acceptance_rate(), **trace.meta}
    print(json.dumps(summary, indent=1))
    return summary


def _cmd_ops(args):
    from repro_torch.profiler.operator_profiler import profile_arch
    trace = profile_arch(args.arch, hardware=args.hw, mode=args.mode,
                         tp=args.tp, device=_engine_device(args, args.hw))
    out = args.out or f"traces/{args.arch}.{trace.hardware}.{args.mode}.json"
    trace.save(out)
    summary = {"trace": out, **trace.meta}
    print(json.dumps(summary, indent=1))
    return summary


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0].startswith("-"):
        argv = ["ops", *argv]      # legacy: python -m ... --arch X

    ap = argparse.ArgumentParser(prog="python -m repro_torch.profiler")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def engine_device(p):
        p.add_argument("--engine-device", default=None,
                       help="torch device the engine runs on in measured "
                            "mode (default: the CPU for a CPU label, else "
                            "the card)")

    p = sub.add_parser(
        "profile", help="emit a HardwareTrace artifact for one device")
    p.add_argument("--device", required=True,
                   help="device name (registry key of the artifact)")
    p.add_argument("--arch", default="llama3.1-8b-tiny")
    p.add_argument("--mode", default="auto",
                   choices=["auto", "measured", "synthetic"],
                   help="auto: measured for cpu-engine/local, synthetic "
                        "(spec-derived) otherwise")
    p.add_argument("--out", default=None,
                   help="output path (default traces/<device>.json)")
    p.add_argument("--tp", default="1",
                   help="tensor-parallel degree(s), comma-separated; "
                        "one grid per degree (measured: tp ranks on tp "
                        "devices of the engine's kind)")
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prefill-buckets", default="16,32,64,128,256",
                   help="measured mode: whole-prompt prefill buckets")
    p.add_argument("--decode-ctxs", default="32,64,128,256",
                   help="measured mode: decode contexts (batches 1, "
                        "max-batch/2 and max-batch at each)")
    p.add_argument("--extend-ctxs", default="16,64,128",
                   help="measured mode: contexts an extend chunk follows")
    p.add_argument("--extend-suffixes", default="16,64,128",
                   help="measured mode: extend chunk sizes")
    engine_device(p)
    # inline spec definition for a brand-new accelerator
    p.add_argument("--peak-flops", type=float, default=None)
    p.add_argument("--hbm-bw", type=float, default=None)
    p.add_argument("--hbm-capacity", type=float, default=None)
    p.add_argument("--link-bw", type=float, default=None)
    p.add_argument("--mmu-efficiency", type=float, default=None,
                   help="achievable fraction of peak on matmuls (default "
                        "0.85 for new specs; overrides a known spec's "
                        "value when given alone)")
    p.add_argument("--experts", nargs="?", const="auto", default=None,
                   metavar="PATH",
                   help="MoE archs: also emit an ExpertRoutingTrace "
                        "artifact (recorded through the engine in "
                        "measured mode, synthesized otherwise) to PATH "
                        "(default traces/<device>.routing.json)")
    p.add_argument("--period", type=int, default=256,
                   help="routing/acceptance-trace position-bucket length")
    p.add_argument("--spec", nargs="?", const="auto", default=None,
                   metavar="PATH",
                   help="also emit an AcceptanceTrace artifact (recorded "
                        "through a speculating engine in measured mode, "
                        "synthesized otherwise) to PATH (default "
                        "traces/<device>.acceptance.json)")
    p.add_argument("--k", type=int, default=4,
                   help="speculative draft length for --spec")
    p.add_argument("--kernels", nargs="?", const="reference,cuda",
                   default=None, metavar="BACKENDS",
                   help="measured mode: also sweep per-kernel latencies "
                        "(attention/mlp/moe_gmm/head) for the given "
                        "comma-separated kernel backends (default "
                        "'reference,cuda') into hwtrace/3 sub-buckets")
    p.set_defaults(fn=_cmd_profile, requests=8, alpha=0.7, jitter=0.0,
                   draft_arch=None, draft_seed=1)

    r = sub.add_parser(
        "record-routing",
        help="emit an ExpertRoutingTrace artifact for a MoE arch: record "
             "the real model's routing through the port's engine, or "
             "synthesize a parameterized skew")
    r.add_argument("--arch", required=True,
                   help="MoE architecture (e.g. granite-moe-1b-a400m-tiny)")
    r.add_argument("--mode", default="measured",
                   choices=["measured", "synthetic"],
                   help="measured: free-running recording tap on the real "
                        "engine; synthetic: parameterized skew generator")
    r.add_argument("--out", default=None,
                   help="output path (default traces/<arch>.routing.json)")
    r.add_argument("--requests", type=int, default=8,
                   help="workload size for measured recording")
    r.add_argument("--max-batch", type=int, default=4)
    r.add_argument("--max-len", type=int, default=256)
    r.add_argument("--period", type=int, default=256,
                   help="position-bucket length of the assignment tables")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--skew", default="zipf",
                   choices=["uniform", "zipf", "correlated"],
                   help="synthetic mode: skew family")
    r.add_argument("--zipf-a", type=float, default=1.1,
                   help="synthetic mode: zipf exponent")
    engine_device(r)
    r.set_defaults(fn=_cmd_record_routing)

    a = sub.add_parser(
        "record-acceptance",
        help="emit an AcceptanceTrace artifact: record draft/target "
             "acceptance through a speculating engine, or synthesize it "
             "from a per-token acceptance rate")
    a.add_argument("--arch", required=True,
                   help="target architecture (e.g. llama3.1-8b-tiny)")
    a.add_argument("--draft-arch", default=None,
                   help="draft architecture (default: the target arch "
                        "itself with another parameter seed)")
    a.add_argument("--mode", default="measured",
                   choices=["measured", "synthetic"],
                   help="measured: real draft proposals verified by the "
                        "real target; synthetic: truncated-geometric "
                        "distributions from --alpha")
    a.add_argument("--out", default=None,
                   help="output path (default "
                        "traces/<arch>.acceptance.json)")
    a.add_argument("--k", type=int, default=4,
                   help="draft proposal length per spec step")
    a.add_argument("--requests", type=int, default=8,
                   help="workload size for measured recording")
    a.add_argument("--max-batch", type=int, default=4)
    a.add_argument("--max-len", type=int, default=256)
    a.add_argument("--period", type=int, default=256,
                   help="position-bucket count of the distributions")
    a.add_argument("--seed", type=int, default=0)
    a.add_argument("--draft-seed", type=int, default=1,
                   help="measured mode: draft parameter seed")
    a.add_argument("--alpha", type=float, default=0.7,
                   help="synthetic mode: per-token target acceptance rate")
    a.add_argument("--jitter", type=float, default=0.0,
                   help="synthetic mode: per-bucket alpha perturbation")
    engine_device(a)
    a.set_defaults(fn=_cmd_record_acceptance)

    o = sub.add_parser(
        "ops", help="operator-level trace (raw Trace, legacy format)")
    o.add_argument("--arch", required=True)
    o.add_argument("--hw", default=None,
                   help="the trace's label (default: cpu-measured, or h100 "
                        "when measured on the card)")
    o.add_argument("--mode", default="measured",
                   choices=["measured", "analytical"])
    o.add_argument("--tp", type=int, default=1)
    o.add_argument("--out", default=None)
    engine_device(o)
    o.set_defaults(fn=_cmd_ops)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
