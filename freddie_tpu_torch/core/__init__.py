"""Host-side record model: CIGAR algebra and locus (tint) construction."""
