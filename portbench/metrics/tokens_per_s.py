"""tokens_per_s (tokens/s): every prompt token the window completed
(batch x seq per batch) over the whole window (host clock)."""


def read(run):
    if run.unit != "tokens":
        return None
    return run.tokens / run.window_s
