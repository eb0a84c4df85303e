"""Device milliseconds a query in sort kernels: torch.sort's radix and
bitonic sorts (CUB's onesweep, histogram and scan passes, the
segmented and in-place forms) and their index set-up."""
from portbench import trace

UNIT, LAYER, MOVES = "ms", "sort", "input_rows_per_s"
PATTERNS = (r"RadixSort", r"radixSort", r"bitonicSort", r"SegmentedSort",
            r"segmented_sort", r"sort_postprocess",
            r"fill_index_and_segment")


def read(r):
    if r.trace is None or not r.queries:
        return None
    s = trace.device_seconds(r.trace, PATTERNS, exclude=r.kernel_symbols())
    return 1e3 * s / r.queries if s > 0 else None
