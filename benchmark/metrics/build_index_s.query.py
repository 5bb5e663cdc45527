"""build_index_s.query: seconds of the host index build in set-up, the
program's `index.build` span total (key runs, probe table attempts,
p_rows fill)."""
from traffic import spans


def read(traced):
    return spans.total_s("index.build")
