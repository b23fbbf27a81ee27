"""The benchmark's frozen arithmetic: the card's peaks and the work each
kernel's inputs need, counted from the pool and the views alone."""
