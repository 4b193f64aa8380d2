"""Mean ms of the train step's synthesis phase over the traced slice, between the
step's own CUDA events (make_train_step's marks)."""


def read(run):
    if not run.phase_ms:
        return None
    return run.phase_ms.get("synthesis")
