"""images_per_s (images/s): every image the window completed over the
whole window, submit of its first batch to the synchronise of its last
(host clock)."""


def read(run):
    if run.unit != "images":
        return None
    return run.rows / run.window_s
