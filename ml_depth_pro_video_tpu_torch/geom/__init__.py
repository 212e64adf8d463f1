"""Host point-cloud geometry: unprojection, ground, cleaning, shapes, floor plans."""
