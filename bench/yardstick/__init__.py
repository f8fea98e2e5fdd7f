"""Frozen yardsticks: the card's peaks, each kernel family's work, and
the models' FLOPs. Later changes to the program do not move them."""
