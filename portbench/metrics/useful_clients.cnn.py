"""% of the client rows the traced chunk trained whose send the server
weighed: the program's ``clients_weighted`` counter (the cohort's kept
rows of live lanes) over ``clients_trained`` (every client row of every
lane, each round)."""
from portbench.yardstick import spans


def read(ctx):
    got = spans.counters(ctx, "clients_weighted", "clients_trained")
    if got is None or got[1] <= 0:
        return None
    return 100.0 * got[0] / got[1]
