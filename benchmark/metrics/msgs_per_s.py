"""msgs_per_s: messages whose QoS 1 acknowledgement resolved inside the
window, over the window's seconds (the harness's clock)."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.acked_in_window / run.window_s
