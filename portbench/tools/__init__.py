"""Tools run by hand on the card: the control, the knee sweep."""
