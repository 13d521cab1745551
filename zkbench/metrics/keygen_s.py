"""keygen_s: the set-up's keygen phase (``setup.keygen``: the fixed and σ
columns, their commitments, the quotient's selector tables), host clock
with the program's synchronize at the phase's end. Moves setup_s."""


def read(ctx):
    return ctx["run"].setup_phases.get("setup.keygen")
