"""upload_s: host seconds of `set_scene()` and `commit()` in the set-up,
ended by a synchronize."""


def read(run):
    return run.upload_s
