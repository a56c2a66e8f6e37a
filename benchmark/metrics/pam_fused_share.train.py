"""pam_fused_share.train: the share of DANet's position-attention calls that
took the fused route, which never holds the whole N×N affinity: the
program's ``danet.pam.sdpa`` counter over every ``danet.pam.*`` counter
(``plain`` holds it whole), over the whole run. On a card it must read 100.
None without a card, and where the program counts no position attention
(every other model, and a program without DANet)."""

from benchmark.work.spans import program_counts


def read(t):
    if t.info.get("kind") != "train" or not t.ops:
        return None
    counts = program_counts() or {}
    total = sum(v for k, v in counts.items() if k.startswith("danet.pam."))
    if total == 0:
        return None
    return 100.0 * counts.get("danet.pam.sdpa", 0) / total
