"""params_s: the set-up's commitment params (the program's span
``setup.params``: the KZG SRS and its host tables, or the IPA
generators), host clock to the card's completion. None where the
program has no such span. Moves setup_s."""


def read(ctx):
    return ctx["run"].setup_phases.get("setup.params")
