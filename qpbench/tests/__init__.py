"""CPU tests of the benchmark harness (cuda-marked ones run on the card)."""
