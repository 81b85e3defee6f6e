"""crops_per_s: crops whose poses reached the host over the window's wall
time, which ends when the last request returns (host clock)."""


def read(r):
    if "crops" not in r.window:
        return None
    return r.window["crops"] / r.window["elapsed_s"]
