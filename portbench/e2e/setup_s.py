"""Process start to the first timed query: imports, the CUDA context,
the kernels' build or load, the tables drawn on the device, ingest and
the warm-up queries."""
UNIT = "s"


def read(r):
    return r.setup_s
