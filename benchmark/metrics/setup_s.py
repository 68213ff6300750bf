"""From the process's start to the window's opening: loading, building and
quantizing the model, warming up every shape, capturing every graph, and
filling the slots where the loop is closed."""


def read(run):
    return run.setup_s
