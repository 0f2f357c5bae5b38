"""Device-busy milliseconds a predict call outside the copies: the
union of the kernels' and fills' intervals in the traced window, over
its calls (ensemble.predict_ensemble_classifier's forward and vote)."""


def read(run):
    busy = run.trace.busy_s(cats=("kernel", "gpu_memset"))
    return 1e3 * busy / len(run.calls) if busy > 0 and run.calls else None
