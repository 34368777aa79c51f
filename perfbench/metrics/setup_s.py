"""Process start to the first timed operation: loading, making the
weights or inputs, building the kernels on a first run, warming up."""


def read(rec):
    return rec.setup_s
