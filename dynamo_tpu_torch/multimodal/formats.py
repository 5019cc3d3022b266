"""What the image decoders share: the ROADMAP items that name each format
or variant left unported, and Pillow's decompression-bomb limit."""

from __future__ import annotations

__all__ = ["ITEM_OTHER_FORMATS", "MAX_IMAGE_PIXELS", "check_size", "undecodable"]

# BMP, TIFF, ICO and Pillow's other formats; CMYK/YCCK, lossless,
# hierarchical, arithmetic-coded and 12-bit JPEG
ITEM_OTHER_FORMATS = "ROADMAP Queue A item 12b-iii"
# Pillow's Image.MAX_IMAGE_PIXELS: past twice this, an image is refused
# unread as a decompression bomb
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3


def undecodable(why: str) -> ValueError:
    return ValueError(f"undecodable image bytes: {why}")


def check_size(width: int, height: int) -> None:
    """Pillow's decompression-bomb guard, before anything is decoded."""
    pixels = width * height
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise undecodable(
            f"Image size ({pixels} pixels) exceeds limit of {2 * MAX_IMAGE_PIXELS} "
            "pixels, could be decompression bomb DOS attack.")
