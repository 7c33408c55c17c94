"""setup_s: seconds from the process's start to the window's opening:
imports, the card, the inputs drawn on it, the program built and warmed up."""


def read(run):
    return run.setup_s
