"""Share of the window's deep-scrub CRC32C bytes whose CRC the card took:
`crc_card_bytes / (crc_card_bytes + crc_host_bytes)` of deep_scrub's
stage_stats, summed over the window's calls, %.  None where the program
keeps no such counts."""

KEYS = ("crc_card_bytes", "crc_host_bytes")


def read(ctx):
    calls = ctx.get("window_calls") or []
    if not any(KEYS[0] in c["stats"] for c in calls):
        return None
    card = sum(c["stats"].get(KEYS[0], 0) for c in calls)
    host = sum(c["stats"].get(KEYS[1], 0) for c in calls)
    if card + host <= 0:
        return None
    return 100.0 * card / (card + host)
