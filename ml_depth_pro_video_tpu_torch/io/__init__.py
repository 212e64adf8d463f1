"""Image input: decoding, EXIF focal length, stream items."""
