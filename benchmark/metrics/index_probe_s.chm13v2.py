"""index_probe_s.chm13v2: seconds of the probe table's build in set-up,
the program's `index.build.probe` span total: every attempt, the k0
rule's that overflow and the pair rule's that builds."""
from traffic import spans


def read(traced):
    return spans.total_s("index.build.probe")
