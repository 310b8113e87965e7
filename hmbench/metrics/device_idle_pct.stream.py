"""The traced window's share (%) with no kernel or copy on the card (the
mean over the cards)."""
from hmbench.layers import idle_pct


def read(view):
    return idle_pct(view)
