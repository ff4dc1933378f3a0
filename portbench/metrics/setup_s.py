"""Set-up time (s): from the process's start to the window's start:
imports, weights, building and warming the program, compiling what it
compiles, and a training cell's checked first steps."""


def read(run):
    return run.setup_s
