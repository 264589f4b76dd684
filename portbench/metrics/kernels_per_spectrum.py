"""Device kernel records (copies and fills left out) in the traced
window, a spectrum: the host's launches."""


def read(run):
    tr = run.trace
    if tr is None or tr.kernels == 0:
        return None
    return tr.kernels / tr.calls
