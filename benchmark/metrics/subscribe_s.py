"""subscribe_s: seconds of the set-up's ``Broker.subscribe`` calls and
the first automaton build (the harness's clock)."""


def read(run):
    return run.subscribe_s
