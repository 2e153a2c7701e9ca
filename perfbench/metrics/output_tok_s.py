"""Output tokens emitted in the wall window over its wall seconds."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 else None
