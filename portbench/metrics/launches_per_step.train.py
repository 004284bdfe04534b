"""Op wrappers: the sum of the training path's `.launches` counters (K1,
K2, K7-K10) over the untraced window, per step."""


def read(r):
    steps = r.result["work"]["steps"]
    return r.result["host"]["launches"] / steps if steps else None
