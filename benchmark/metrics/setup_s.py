"""Set-up seconds: from the harness's start to the window's (imports,
weights, data, kernel builds and loads, warm-up)."""


def read(run):
    return run.setup_s
