"""The plain references that decide ``correct``, one module a family.

A configuration file names its family's module under ``reference``, a
path below ``perfbench/reference/`` (``decoder.py``: the pre-norm
decoder of GQA attention with a GELU MLP or SwiGLU experts).
``cells.load`` loads it from that path, so a family is added as a file
alone.  The module imports nothing of the program and exports:

* ``covers(cfg) -> Optional[str]``: None where its reference computes the
  program's ``ArchConfig``, else why not (the harness refuses such a
  configuration with that reason);
* ``make_params(sizes, seed, device, dtype)``: the weights drawn from the
  seed on the device, in the program's nested layout;
* ``logits_at(params, sizes, seqs, want, *, quantize=None, device=None)``:
  the float32 logits at the positions ``want`` of each sequence, with
  TF32 off on a card; ``quantize="fp8"`` is the control;
* ``model_flops(sizes, chunks)``: model FLOPs of the tokens processed,
  ``chunks`` of (start, n, logits), as ``counts.model_flops`` counts them.

``sizes`` is the configuration file's ``sizes`` with ``padded_vocab``.
"""
