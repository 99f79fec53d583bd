"""Seconds from the process's start to the first timed unit of work:
imports, building the system, weights, warm-up and every compile."""


def read(run):
    return run.setup_s
