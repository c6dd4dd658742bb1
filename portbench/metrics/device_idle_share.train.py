"""Share of the untraced training window in which no kernel, copy or set
ran on the card, in %: one less the card's busy seconds an episode (the
union of its intervals in the segment traced on the card alone, over that
segment's episodes) times the window's episodes a second. Kernel times do
not depend on the host's pace, but even a trace of the card alone slows
host-bound issue by a quarter to two fifths, so the traced segment's own
idle share (the result line's ``busy_s`` over ``window_s``) reads
high; this reads the pace that ``train_episodes_per_s`` reads. Layer: the
device."""


def read(run):
    w = run.window
    if not run.card.device or not run.card_episodes or \
            not w.get("episodes") or w.get("wall_s", 0) <= 0:
        return None
    busy = run.card.busy_s() / run.card_episodes
    return 100.0 * (1.0 - busy * w["episodes"] / w["wall_s"])
