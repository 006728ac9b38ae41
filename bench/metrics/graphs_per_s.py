"""Graphs whose trussness came back to the client, per second of the
window (the last slice finished past the close)."""


def read(run):
    """Host clock, graphs per second."""
    done = run.records.get("graphs_returned")
    return done / run.window_s if done else None
