"""95th percentile, over every request whose first token falls in the
window, of (last token - first token) / (tokens - 1), in ms."""

from pbcore.stats import percentile


def read(rec):
    return percentile(rec.tl.tpot_ms(), 95)
