"""The protocol variants of the shared engine (``Settings.protocol_variant``).

``ring`` carries votes and cut reports around the static ring-0 order
(transport only: decisions and config ids equal "rapid"'s); ``hier``
decides a fast round by seeded groups' quorums. Both change the logged
message factors. ``engine.step`` dispatches on the setting.
"""

#: Every protocol variant a campaign member may run.
VARIANTS = ("rapid", "ring", "hier")
