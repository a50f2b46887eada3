"""setup_s: seconds from the start of the process to the first timed
message (the harness's clock)."""


def read(run):
    return run.setup_s
