"""The fat-tree fabric simulator and its experiment front door."""
