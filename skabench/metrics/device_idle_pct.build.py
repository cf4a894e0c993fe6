"""device_idle_pct.build: the share of the traced window of the build cell in which
no kernel, copy or fill ran on the card (100 less the union of their
intervals), in %."""


def read(trace, run):
    return trace.idle_pct()
