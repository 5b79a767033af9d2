"""Process start to the first timed call: imports, the device's start-up,
loading (on a checkout's first run, building) the kernels, the inputs made
from the seed, the program built, its checked first call and one warm
call."""


def read(window):
    return window.setup_s
