"""abn_fused_share.serve: the share of eval-mode ABN calls that took the
hand-written kernel: the program's ``abn.eval.fused`` counter over it and
``abn.eval.plain``, over the whole run. None without a card, and where
the program counts neither (one older than the kernel)."""

from benchmark.work.spans import program_counts


def read(t):
    if t.info.get("kind") != "serve" or not t.ops:
        return None
    counts = program_counts() or {}
    fused, plain = counts.get("abn.eval.fused", 0), counts.get("abn.eval.plain", 0)
    if fused + plain == 0:
        return None
    return 100.0 * fused / (fused + plain)
