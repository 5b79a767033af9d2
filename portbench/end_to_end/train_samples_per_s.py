"""Minibatch rows consumed by completed updates over the whole window: from
the first call's dispatch to the synchronised end of the last, every call's
fixed costs included.  A step that failed is no work.  What a refresh's wall
time divides."""


def read(window):
    if "samples" not in window.work:
        return None
    return window.work["samples"] / window.seconds
