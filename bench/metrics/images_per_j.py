"""Images over the card's energy in the window (the paper's throughput to
power ratio); none where no energy was read."""


def read(run):
    if not run.energy_j:
        return None
    return run.images / run.energy_j
