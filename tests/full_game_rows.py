"""The rule events of a full game staged in its rows, for the full-rule
tests (tests/test_torch_full_game.py on the CPU, ..._card.py on a card).
No JAX here."""

from madrona_basketball_tpu_torch import constants as C
from madrona_basketball_tpu_torch.ops.layout import F_IDX, I_IDX

BLOCK = 64      # the staging repeats every BLOCK worlds
SCORE, OOB, CLOCK, INBOUND, HELD = (range(0, 8), range(8, 16),
                                    range(16, 24), range(24, 32),
                                    range(32, 48))
CLASSES = {"score": SCORE, "oob": OOB, "clock": CLOCK, "inbound": INBOUND,
           "held": HELD, "as_made": range(48, BLOCK)}


def stage(sf, si):
    """Stage the rule events in the numpy rows (72, W), (59, W) of a full
    game, in place, by world w % BLOCK (tests/test_golden_oracle.py's
    surgeries, over rows): a 3-point shot going in at hoop 1's zone
    (SCORE), a loose ball 5 cm past the sideline last touched by team 0
    (OOB: the inbound pass from there goes back in; from 30 cm out it goes
    straight out again, and the turnover puts the next inbounder onto the
    passer, where the collision's push depends on the sign of a dot
    product that is 0 in exact arithmetic),
    a quarter's last tick (CLOCK), an inbounder with 0.05 s left to pass
    (INBOUND), the ball held by agent w % 2 at its feet (HELD); the other
    worlds as they are.  Returns (sf, si)."""
    f, i = F_IDX, I_IDX
    for w in range(sf.shape[1]):
        k = w % BLOCK
        if k in SCORE:
            sf[f["bpos_x"], w], sf[f["bpos_y"], w] = 28.70, 8.5
            si[i["binflight"], w], si[i["bgrabbed"], w] = 1, 0
            si[i["bsb_agent"], w], si[i["bsb_team"], w] = C.AGENT_IDS[0], 0
            si[i["bspv"], w], si[i["bsgi"], w] = 3, 1
            for a in range(2):
                si[i[f"a{a}.has_ball"], w] = 0
                si[i[f"a{a}.held_ball"], w] = C.ENTITY_ID_PLACEHOLDER
        elif k in OOB:
            sf[f["bpos_y"], w] = C.COURT_MIN_Y - 0.05
            si[i["blt_team"], w] = 0
        elif k in CLOCK:
            sf[f["gclock"], w] = 0.01
        elif k in INBOUND:
            si[i["ginb"], w], si[i["glive"], w] = 1, 0
            sf[f["iclock"], w], sf[f["tip"], w] = 0.05, 0.0
            si[i["a0.im_inb"], w], si[i["a0.has_ball"], w] = 1, 1
            si[i["a0.held_ball"], w] = C.BALL_ID
            si[i["bgrabbed"], w], si[i["bholder"], w] = 1, C.AGENT_IDS[0]
        elif k in HELD:
            a = w % 2
            for b in range(2):
                si[i[f"a{b}.has_ball"], w] = int(a == b)
                si[i[f"a{b}.held_ball"], w] = C.BALL_ID if a == b else \
                    C.ENTITY_ID_PLACEHOLDER
            si[i["bgrabbed"], w], si[i["bholder"], w] = 1, C.AGENT_IDS[a]
            sf[f["tip"], w] = float(a)
            for x in ("x", "y"):
                sf[f[f"bpos_{x}"], w] = sf[f[f"a{a}.pos_{x}"], w]
    return sf, si
