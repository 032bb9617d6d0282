"""The median time the server held its render lock per hierarchical
request over the untraced window, as the server's ``GET /stats`` reports
it (p50 of its last 1,000 renders): the render alone, without the queue,
HTTP or PNG."""


def read(r):
    if r.get("kind") != "serve_hier":
        return None
    return r["render_ms"]
