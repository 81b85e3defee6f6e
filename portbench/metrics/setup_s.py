"""setup_s: seconds from the process's start to the first timed request or
step (host clock): loading, weights, inputs, kernel builds, warm-up."""


def read(r):
    return r.setup_s
