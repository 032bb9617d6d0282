"""The device's idle share of a served hierarchical render: one less the
union of its operations' intervals over the time the server held its
render lock, in a traced stretch of renders one at a time, in percent
(as ``device.idle_share.render`` reads the coarse cell)."""


def read(r):
    if r.get("kind") != "serve_hier" or not r.get("trace") \
            or r["trace"]["busy_s"] <= 0 or r["held_s"] <= 0:
        return None
    return 100.0 * (1.0 - r["trace"]["busy_s"] / r["held_s"])
