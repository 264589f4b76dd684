"""Seconds a spectrum: the window's wall over the spectra completed in
it (closed loop, one caller; each call ends with P(k) on the host)."""


def read(run):
    return run.window_s / len(run.walls)
