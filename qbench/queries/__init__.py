"""Query kinds a traffic mix can name (``"op"``), one module each: how the
engine is asked (``program``), the plain reference (``reference``), which
answer columns are keys, exact or float (``kinds``) and the bytes the query
has to move at least (``hbm_bytes``)."""
