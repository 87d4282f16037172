"""Seconds from process start to the window's start: imports, the CUDA
context, the record pool, the backlog, the writer's start-up and its
warm-up until every worker thread has published a file."""


def read(run):
    return run.w0 - run.t_start
