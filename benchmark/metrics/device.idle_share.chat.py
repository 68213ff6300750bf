"""The share of the traced slice in which no operation ran on the card."""


def read(run):
    return run.idle_share()
