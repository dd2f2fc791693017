"""Host seconds of the program's convert and the state's move to the
device (``harness.Run.setup``)."""


def read(ctx):
    return ctx["run"].convert_s
