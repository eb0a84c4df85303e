"""The `permute_rows` kernel's share of its roofline: its stage's bytes
in every traced query at the card's memory rate, over its device time."""
from portbench import roofline

UNIT, LAYER, MOVES = "%", "sort", "input_rows_per_s"


def read(r):
    got = roofline.kernel_times(r, "permute_rows")
    return None if got is None else 100.0 * got[0] / got[1]
