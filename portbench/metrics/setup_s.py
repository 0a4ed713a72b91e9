"""Seconds from the run's start to the window's: imports, the scene made
on the card, the program's layout build and one warm-up call (the first
run in a checkout also builds the kernel library)."""


def read(rec):
    return rec["setup_s"]
