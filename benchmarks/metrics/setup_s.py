"""setup_s (s, host clock): process start to the first timed call: the
interpreter and imports, Init, the inputs made on the device from the
seed, plans built and the cell's own shapes warmed."""


def read(rec):
    return rec.get("setup_s")
