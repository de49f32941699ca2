"""Model layer: torch WaveNet, output heads, AR generation."""
