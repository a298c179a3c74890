"""Request outcome vocabulary of the serving engines (port of the part of
``repro/serving/lifecycle.py`` that the lookup engine uses)."""

# LookupResult.status values
STATUS_OK = "ok"                # answered
STATUS_CANCELLED = "cancelled"  # cancel(uid) before it was served
STATUS_SHED = "shed"            # bounded queue rejected it (overload)

SHED_POLICIES = ("reject_new", "evict_lowest")
