"""The most device memory the allocator held during the window
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""
UNIT, LAYER, MOVES = "GiB", "device", "input_rows_per_s"


def read(r):
    return r.window_peak_bytes / 2 ** 30 if r.window_peak_bytes else None
