"""``CudaEngine.wait_s`` (host time spent waiting on the device for a
group's results) as a share of the realign stage's printed runtime."""
from benchmark import printed


def read(run):
    wait = stage = 0.0
    for c in run.calls:
        rt = printed.realign_runtime(c["lines"])
        if rt is None or "wait_s" not in c["counters"]:
            return None
        wait += c["counters"]["wait_s"]
        stage += rt[1]
    return 100 * wait / stage if stage else None
