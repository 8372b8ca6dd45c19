"""capture_s: host seconds of the first ``run`` call, the cards waited
for: the warm-up step and the capture of the step graph (on several
cards, every card's segments)."""


def read(rec):
    return rec.capture_s
