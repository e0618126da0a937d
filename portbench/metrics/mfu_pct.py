"""The whole step's share of the card's peak: images completed in the
window times the configuration's floor per image (the larger of its FLOPs
at the f32 peak and its bytes at the HBM peak, ``work.py``), over the
window's seconds."""


def read(rec):
    if not rec.get("images"):
        return None
    return 100.0 * rec["images"] * rec["floor_s_per_img"] / rec["window_s"]
