"""Work counts and the card's peaks, one file per model family."""
