"""host_syncs.serve: blocking transfers between the host and the card per
served image: the program's ``sync.*`` counters over its
``serve.requests``, both over the whole run. None without a card."""

from benchmark.work.spans import per, program_counts


def read(t):
    if t.info.get("kind") != "serve" or not t.ops:
        return None
    return per(program_counts(), "sync.", "", "serve.requests")
