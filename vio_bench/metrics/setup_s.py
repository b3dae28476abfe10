"""Seconds from the process's start to the window's: imports, the kernels'
build or load, the world and its frames, the pipeline, and the warm-up that
initializes the estimator and captures every device program."""


def read(run):
    return run["setup_s"]
