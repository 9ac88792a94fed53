"""Host seconds the run's compiled programs spent capturing their CUDA
graphs (``engine/compiled.py``: each entry's ``capture_s``), a part of the
set-up."""


def read(run):
    return run.capture_s if run.capture_s else None
